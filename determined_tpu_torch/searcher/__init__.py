"""Custom searcher client, the port's counterpart of
determined_tpu/searcher/ (reference: harness/determined/searcher/).

A user subclasses :class:`SearchMethod` (op model Create / ValidateAfter /
Close / Shutdown, reference _search_method.py:99-201) and drives a
multi-trial experiment with :class:`RemoteSearchRunner`
(_remote_search_runner.py:14) against the master's custom-searcher event
queue.
"""

from determined_tpu_torch.searcher._search_method import (  # noqa: F401
    Close,
    Create,
    Operation,
    Progress,
    SearchMethod,
    Shutdown,
    ValidateAfter,
)
from determined_tpu_torch.searcher._remote_search_runner import RemoteSearchRunner  # noqa: F401
