"""DistributedContext — process topology, one process.

Counterpart of determined_tpu/core/_distributed.py in its `local()` form:
rank 0 of 1. Multi-process training and the control-plane collectives
(`torch.distributed`) are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class DistributedContext:
    rank: int = 0
    size: int = 1

    @property
    def is_chief(self) -> bool:
        return self.rank == 0

    @classmethod
    def local(cls) -> "DistributedContext":
        return cls(rank=0, size=1)

    def shutdown(self) -> None:
        return None
