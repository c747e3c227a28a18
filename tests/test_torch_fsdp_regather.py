"""FSDP's gathered layer weights are not kept for the backward, on the
CPU: a step at ``--mesh data=1,fsdp=2`` on a gang of two gloo ranks
(``torch_gang_worker.py``) all-gathers each sharded layer leaf twice,
with per-layer remat (the checkpoint's recompute) and without it
(``mesh_lib.regathering``: autograd saves the block and the backward
gathers again).
"""
from __future__ import annotations

import dataclasses
import signal

import pytest

import torch_gang_cases as cases_lib
import torch_gang_worker


@pytest.fixture(autouse=True)
def _time_limit():
    def _fail(signum, frame):
        raise TimeoutError('test exceeded its 120 s budget')
    old = signal.signal(signal.SIGALRM, _fail)
    signal.alarm(120)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def test_remat_gathers_the_layer_weights_again_in_the_backward(tmp_path):
    """A step all-gathers each sharded layer leaf twice, once in the
    forward and once in the backward, with or without remat: the
    checkpoint's recompute gathers again, and without it autograd keeps
    the block and gathers when the backward reads the weight
    (``mesh_lib.regathering``), so no gathered weight is kept. The
    embedding, the final norm and the LM head are gathered once."""
    counts = {}
    for remat in (True, False):
        cfg = dataclasses.replace(cases_lib.MODELS['llama_wide'][1],
                                  remat=remat)
        spec = dict(model=cfg, init=None,
                    train=dict(global_batch_size=cases_lib.BATCH,
                               seq_len=cases_lib.SEQ, optimizer='adafactor',
                               mesh_plan=dict(data=1, fsdp=2)),
                    batches=cases_lib.batches(False)[:1],
                    count_gathers=True)
        counts[remat] = torch_gang_worker.run_gang(
            [spec], 2, str(tmp_path))[0][0]['gathers']
    layer_leaves, top = 9, 3   # 7 weights, 2 norms; embed, norm, head
    n = cases_lib.MODELS['llama_wide'][1].n_layers
    assert counts[True] == counts[False] == [2 * layer_leaves * n + top]
