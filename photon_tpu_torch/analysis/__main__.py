"""``python -m photon_tpu_torch.analysis``: the lint gate (analysis/cli.py)."""
import sys

from photon_tpu_torch.analysis.cli import main

if __name__ == "__main__":
    sys.exit(main())
