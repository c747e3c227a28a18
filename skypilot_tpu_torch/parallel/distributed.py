"""Multi-host bring-up from the gang launcher's environment.

Counterpart of ``skypilot_tpu/parallel/distributed.py``. The gang
launcher exports ``XSKY_HOST_RANK``, ``XSKY_NUM_HOSTS`` and
``XSKY_COORDINATOR_ADDRESS`` on every host; the reference turns them
into ``jax.distributed.initialize`` arguments. The port runs on one
host: there :func:`initialize` does nothing, as the reference does. A
gang of more than one host needs ``torch.distributed`` process groups,
which are not ported yet (ROADMAP.md queue 1 item 8), so it raises.
"""
from __future__ import annotations

import logging
import os
from typing import Optional

logger = logging.getLogger(__name__)


def is_multihost() -> bool:
    return int(os.environ.get('XSKY_NUM_HOSTS', '1')) > 1


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Read the gang env (arguments win); a no-op on a single host."""
    coordinator_address = coordinator_address or os.environ.get(
        'XSKY_COORDINATOR_ADDRESS')
    num_processes = num_processes if num_processes is not None else int(
        os.environ.get('XSKY_NUM_HOSTS', '1'))
    process_id = process_id if process_id is not None else int(
        os.environ.get('XSKY_HOST_RANK', '0'))
    if num_processes <= 1 or not coordinator_address:
        logger.debug('Single-host run; no process group to bring up.')
        return
    raise NotImplementedError(
        f'A gang of {num_processes} hosts (this is rank {process_id}, '
        f'coordinator {coordinator_address}) needs torch.distributed '
        'process groups, which are not ported yet: ROADMAP.md queue 1 '
        'item 8, "more than one card".')
