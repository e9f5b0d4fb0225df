"""Retrieval evaluation: CMC/mAP, the serving embed and `run_inference`."""

from .cmc_map import evaluate_all, evaluate_rerank

__all__ = ["evaluate_all", "evaluate_rerank"]
