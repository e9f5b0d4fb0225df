"""Synthetic person images on the card, named after the root launcher
`synthetic_main.py`:

    python -m reid_tpu_torch.synthetic_main --root market1501 \
        [--groups 2] [--epochs 120] [--bs 64] [--n_images 1000] \
        [--vae [--wasserstein]] [--embed_ckpt resnet50.pt] \
        [--ckpt_dir checkpoint] [--out synthetic_images]

Trains the DCGAN per appearance group (or the VAE-GAN) on the train and
gallery images (`gan/driver.py`) and writes gen_*.jpg samples.
"""

import sys

from .cli import gan_main

if __name__ == "__main__":
    gan_main(sys.argv[1:], device="cuda")
