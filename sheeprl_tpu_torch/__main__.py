"""``python -m sheeprl_tpu_torch [overrides...]`` — train (``cli.run``)."""

import sys

from sheeprl_tpu_torch.cli import run

if __name__ == "__main__":
    run(sys.argv[1:])
