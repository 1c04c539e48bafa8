"""`python -m sgrt_tpu_torch.render`: an alias of the CLI (see sgrt_tpu_torch.cli)."""

import sys

from sgrt_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
