"""FSDP's gathered layer weights are not kept for the backward, on the
CPU: a step at ``--mesh data=1,fsdp=2`` on a gang of two gloo ranks
(``torch_gang_worker.py``) all-gathers each sharded layer leaf twice,
with per-layer remat (the checkpoint's recompute) and without it
(``mesh_lib.regathering``: autograd saves the block and the backward
gathers again).

At ``data=1,fsdp=2,tensor=2`` on four ranks, Llama and Qwen-2 (Q/K/V
biases), remat on and off: each split layer leaf is gathered twice a
step, no gathered layer weight's storage is alive when the backward
starts (a tensor rank reads ``wk``/``wv`` through ``llama.local_kv``, a
slice of the gathered leaf, which autograd saves: ``mesh_lib._pack``
saves a view of a gathered weight as the block and the view's place, and
gathers again in the backward), and the steps with and without remat are
bit for bit the same.
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


@pytest.mark.parametrize('model', ['llama_wide', 'qwen_tiny'])
def test_no_gathered_weight_outlives_its_layer_at_fsdp2_tensor2(tmp_path,
                                                                model):
    specs = []
    for remat in (True, False):
        cfg = dataclasses.replace(cases_lib.MODELS[model][1], remat=remat)
        specs.append(dict(
            model=cfg, init=None, batches=cases_lib.batches(False)[:2],
            train=dict(global_batch_size=cases_lib.BATCH,
                       seq_len=cases_lib.SEQ,
                       mesh_plan=dict(data=1, fsdp=2, tensor=2)),
            count_gathers=True))
    ranks = torch_gang_worker.run_gang(specs, 4, str(tmp_path))
    cfg = cases_lib.MODELS[model][1]
    # 7 weights and 2 norms a layer have an fsdp dim (Qwen-2's biases
    # have none); the embedding, the final norm and the head.
    layer_leaves, top = 9, 3
    for rank in ranks:
        with_remat, without = rank
        for run in (with_remat, without):
            assert run['gathers'] == [2 * layer_leaves * cfg.n_layers + top
                                      ] * 2
        # Each layer leaf's gathers by the layer (the remat's recompute
        # gathers again through the layer; without it the backward's
        # regather is mesh_lib._unpack's): none of the forward's is alive
        # when the backward starts.
        assert with_remat['live_gathered'] == [
            (2 * layer_leaves * cfg.n_layers, [0])] * 2
        assert without['live_gathered'] == [
            (layer_leaves * cfg.n_layers, [0])] * 2
        assert with_remat['losses'] == without['losses']
        assert with_remat['grad_norms'] == without['grad_norms']
        cases_lib.assert_trees_close(with_remat['state'], without['state'],
                                     atol=0)
