"""Eval forwards and whole-dataset embedding (training is a later slice)."""
