"""Training and evaluation of the port: the train step, its state and
optimizers, the image-ReID train loops and the eval forwards."""
