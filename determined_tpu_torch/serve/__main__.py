"""`python -m determined_tpu_torch.serve cfg.json` — the serve replica."""

import sys

from determined_tpu_torch.serve.task import main

if __name__ == "__main__":
    sys.exit(main())
