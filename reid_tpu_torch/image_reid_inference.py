"""Retrieval evaluation on the card, named after the root launcher
`image_reid_inference.py`:

    python -m reid_tpu_torch.image_reid_inference --root market1501 \
        --ckpt model.npz [--no-rerank] [--search_option dense] [--int8]

`--ckpt` is the `.npz` of the flax variable tree (`utils/flax_bridge.py`).
"""

import sys

from .cli import inference_main
from .parallel import close_process_group

if __name__ == "__main__":
    try:
        inference_main(sys.argv[1:], device="cuda")
    finally:
        close_process_group()
