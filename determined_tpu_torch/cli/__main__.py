import sys

from determined_tpu_torch.cli import main

sys.exit(main())
