import sys

from sgrt_tpu_torch.cli import main

sys.exit(main())
