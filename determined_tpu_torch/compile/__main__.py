"""`python -m determined_tpu_torch.compile` — the port's farm worker
entrypoint (compile/worker.py). It builds the kernel libraries with nvcc
for the target arch of the flags: no card is needed, and no device is
touched."""

import sys

from determined_tpu_torch.compile.worker import main

sys.exit(main())
