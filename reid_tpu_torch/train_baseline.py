"""The LSRO baseline on the card, named after the root launcher
`train_baseline.py`:

    python -m reid_tpu_torch.train_baseline --root market1501 \
        --gen_dir synthetic_images [--bs 32] [--epochs 25] [--lr 1e-3] \
        [--backbone baseline] [--ckpt baseline.npz]

Trains the classifier on the real train split and the generated images
under the LSRO loss (`gan/driver.py:train_lsro_baseline`).
"""

import sys

from .cli import lsro_main

if __name__ == "__main__":
    lsro_main(sys.argv[1:], device="cuda")
