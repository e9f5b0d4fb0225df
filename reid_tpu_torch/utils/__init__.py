"""Weight bridge from flax variables and int8 post-training quantization."""
