"""``python -m nomad_tpu_torch.cli`` entry point (reference: main.go:15)."""

import sys

from .commands import main

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
