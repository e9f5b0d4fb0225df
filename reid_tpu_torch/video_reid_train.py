"""Video ReID training on the card, named after the root launcher
`video_reid_train.py`:

    python -m reid_tpu_torch.video_reid_train \
        --gt_paths MOT16/train/MOT16-02/gt/gt.txt \
        MOT16/train/MOT16-04/gt/gt.txt --prefix MOT16/train/ \
        [--bs 8] [--epochs 25] [--seq_len 10] [--crop_factor 1.0]

Trains the 3-D video ResNet-50 on the tracklets of the gt.txt files
(`train/video_train.py`) and prints the final loss.
"""

import sys

from .cli import video_main
from .parallel import close_process_group

if __name__ == "__main__":
    try:
        video_main(sys.argv[1:], device="cuda")
    finally:
        close_process_group()
