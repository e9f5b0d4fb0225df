"""Image-ReID training on the card, named after the root launcher
`image_reid_train.py`:

    python -m reid_tpu_torch.image_reid_train --root market1501 \
        [--epochs 60] [--xbm] [--ckpt init.npz] [--export reid.pt2] \
        [--continual --target_dataset dukemtmc --target_root duke]

The checkpoint is written to checkpoint/cnn_net_checkpoint_{dataset}.npz
(the flax variable tree, `utils/flax_bridge.py`), which
`image_reid_inference --ckpt` and `cli --ckpt` read.
"""

import sys

from .cli import train_main
from .parallel import close_process_group

if __name__ == "__main__":
    try:
        train_main(sys.argv[1:], device="cuda")
    finally:
        close_process_group()
