"""``python -m eda_tpu_torch.train``: the port's training CLI (``train/cli.py``)."""

import sys

from eda_tpu_torch.train.cli import main

if __name__ == "__main__":
    sys.exit(main())
