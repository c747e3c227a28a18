"""Rules the PyTorch port keeps, checked on the CPU.

* No module of ``skypilot_tpu_torch`` (nor ``chip_smoke.py``, nor the
  ``tools/torch_*.py`` scripts) imports jax or anything of
  ``skypilot_tpu``.
* Entry points (the engine, ``init``, the ``Trainer``, the launcher, the
  converter, the classifier, the profiler's ``capture``) run on the card
  unless the caller asks for the CPU: without a card and without
  ``device='cpu'`` they raise.
* Every CUDA source under ``csrc/`` is built by the kernel registry, and
  a kernel wrapper handed a non-CPU tensor launches or raises — it never
  falls back to its plain version.
* ``chip_smoke.py`` fails without a card, and alone in a directory.
"""
from __future__ import annotations

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

from skypilot_tpu_torch.infer import engine as engine_lib
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.ops import decode_attention
from skypilot_tpu_torch.ops import flash_attention
from skypilot_tpu_torch.ops import kernels
from skypilot_tpu_torch.ops import mla_decode
from skypilot_tpu_torch.train import trainer

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / 'skypilot_tpu_torch').rglob('*.py')) + [
    REPO / 'chip_smoke.py'] + sorted((REPO / 'tools').glob('torch_*.py'))


def _imported_modules(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize('path', PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax_and_nothing_of_the_jax_package(path):
    banned = [m for m in _imported_modules(path)
              if m.split('.')[0] in ('jax', 'jaxlib', 'skypilot_tpu',
                                     'flax', 'optax')]
    assert not banned, f'{path} imports {banned}'


def test_native_loader_builds_from_the_port_copy():
    """The token loader's C++ source is the port's own copy, and the
    build reads nothing of the JAX package."""
    from skypilot_tpu_torch.train import data
    src = pathlib.Path(data._SOURCE).resolve()
    assert src == REPO / 'skypilot_tpu_torch' / 'native' / 'dataloader.cc'
    text = src.read_text()
    assert 'xsky_dl_open' in text and '#include "' not in text


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)


def test_entry_points_raise_without_a_card(no_card):
    cfg = engine_lib.EngineConfig(model=llama.LLAMA_TINY, max_slots=2,
                                  max_target_len=32, prefill_buckets=(16,))
    params = llama.init(llama.LLAMA_TINY, device='cpu')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        engine_lib.InferenceEngine(cfg, params)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        llama.init(llama.LLAMA_TINY)
    engine = engine_lib.InferenceEngine(cfg, params, device='cpu')
    assert engine.device.type == 'cpu'
    train_cfg = trainer.TrainConfig(model=llama.LLAMA_TINY,
                                    global_batch_size=2, seq_len=8)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        trainer.Trainer(train_cfg)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        trainer.measure_throughput(trainer.Trainer(train_cfg), num_steps=1)
    assert trainer.Trainer(train_cfg, device='cpu').device.type == 'cpu'


def test_training_entry_points_raise_without_a_card(no_card, tmp_path):
    """The launcher and the converter, like every entry point: the card
    unless the caller asks for the CPU."""
    from skypilot_tpu_torch.models import convert
    from skypilot_tpu_torch.train import launch
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        launch.main(['--model', 'tiny', '--steps', '1'])
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        convert.from_hf(str(tmp_path))
    out = launch.run(launch.parse_args(
        ['--model', 'tiny', '--steps', '1', '--global-batch-size', '2',
         '--seq-len', '8', '--device', 'cpu']))
    assert out['trainer'].device.type == 'cpu'


def test_classifier_and_capture_raise_without_a_card(no_card, tmp_path,
                                                     capsys):
    """The classifier (``train/classify.py``) and the profiler's deep
    capture, like every entry point: the card unless asked for the CPU."""
    from skypilot_tpu_torch.agent import profiler
    from skypilot_tpu_torch.train import classify
    cfg = classify.ClassifyConfig(model=llama.LLAMA_TINY, seq_len=8,
                                  batch_size=2)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        classify.train(cfg, steps=1)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        classify.main(['--model', 'tiny', '--steps', '1'])
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        profiler.main(['capture', '--out', str(tmp_path / 'card')])
    assert classify.main(['--model', 'tiny', '--steps', '1', '--seq-len',
                          '8', '--batch-size', '2', '--device', 'cpu']) == 0
    assert profiler.main(['capture', '--out', str(tmp_path / 'cpu'),
                          '--duration', '0.2', '--device', 'cpu']) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert '"classify_eval_accuracy"' in lines[-2]
    assert '"device_kind": "cpu"' in lines[-1]


def test_every_cuda_source_is_built():
    csrc = pathlib.Path(kernels.CSRC_DIR)
    sources = {p.name for p in csrc.glob('*.cu')}
    assert sources == {k.source for k in kernels.REGISTRY}
    assert {k.name for k in kernels.REGISTRY} == {
        'flash_fwd', 'flash_bwd_dkv', 'flash_bwd_dq', 'decode_attention',
        'paged_decode_attention', 'mla_decode', 'paged_mla_decode'}
    for kern in (flash_attention.KERNEL, flash_attention.DKV_KERNEL,
                 flash_attention.DQ_KERNEL, decode_attention.KERNEL,
                 decode_attention.PAGED_KERNEL, mla_decode.KERNEL,
                 mla_decode.PAGED_KERNEL):
        assert kern in kernels.REGISTRY
    # The dense and the paged decode kernels (K4/K5, and the MLA pair
    # K6/K7) are two sources, two libraries and two launch counts; a
    # shared header reaches both.
    assert (decode_attention.KERNEL.library_path() !=
            decode_attention.PAGED_KERNEL.library_path())
    assert (csrc / 'decode_common.cuh').exists()
    assert (mla_decode.KERNEL.library_path() !=
            mla_decode.PAGED_KERNEL.library_path())
    assert (csrc / 'mla_common.cuh').exists()
    # The two backward kernels share one source and so one library.
    assert (flash_attention.DKV_KERNEL.library_path() ==
            flash_attention.DQ_KERNEL.library_path() !=
            flash_attention.KERNEL.library_path())


def test_build_report_is_kept_beside_the_library(tmp_path, monkeypatch):
    """nvcc's -Xptxas -v report (registers, spills) is saved next to the
    built library, so a later process that reuses the library still has
    it (chip_smoke.py prints it in phase [2]). nvcc here is a stand-in
    script; loading the library is skipped."""
    monkeypatch.setattr(kernels, 'BUILD_DIR', str(tmp_path / 'build'))
    monkeypatch.setattr(kernels, 'REGISTRY', [])
    monkeypatch.setattr(kernels.Kernel, '_load',
                        lambda self, path: setattr(self, '_fn', print))
    nvcc = tmp_path / 'nvcc'
    nvcc.write_text('#!/bin/sh\nwhile [ $# -gt 1 ]; do [ "$1" = -o ] && '
                    'out=$2; shift; done\n: > "$out"\n'
                    'echo "ptxas info    : Used 42 registers"\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(kernels, 'nvcc_path', lambda: str(nvcc))
    first = kernels.Kernel('k', 'flash_fwd.cu', 'xsky_flash_fwd', [])
    kernels.build_all([first])
    assert 'Used 42 registers' in first.build_log
    monkeypatch.setattr(kernels, 'nvcc_path', lambda: '/nonexistent/nvcc')
    again = kernels.Kernel('k', 'flash_fwd.cu', 'xsky_flash_fwd', [])
    assert kernels.build_all([again]) == {'flash_fwd.cu': 0.0}
    assert again.build_log == first.build_log


def test_wrappers_never_fall_back_on_a_device_tensor():
    """A tensor that is not on the CPU goes to the kernel's launcher,
    which raises for anything but a CUDA tensor; no launch is counted."""
    q = torch.zeros((1, 64, 4, 16), device='meta')
    k = torch.zeros((1, 64, 2, 16), device='meta')
    before = flash_attention.KERNEL.launches
    with pytest.raises(ValueError, match='launches a CUDA kernel'):
        flash_attention.flash_attention(q, k, k)
    assert flash_attention.KERNEL.launches == before
    qd = torch.zeros((2, 1, 4, 16), device='meta')
    cache = torch.zeros((2, 32, 2, 16), device='meta')
    lengths = torch.zeros((2,), dtype=torch.int32, device='meta')
    before = decode_attention.KERNEL.launches
    with pytest.raises(ValueError, match='launches a CUDA kernel'):
        decode_attention.decode_attention(qd, cache, cache, lengths)
    assert decode_attention.KERNEL.launches == before
    pages = torch.zeros((6, 8, 2, 16), device='meta')
    tables = torch.zeros((2, 4), dtype=torch.int32, device='meta')
    before = decode_attention.PAGED_KERNEL.launches
    with pytest.raises(ValueError, match='launches a CUDA kernel'):
        decode_attention.paged_decode_attention(qd, pages, pages, lengths,
                                                tables)
    assert decode_attention.PAGED_KERNEL.launches == before
    q_eff = torch.zeros((2, 4, 32), device='meta')
    q_rope = torch.zeros((2, 4, 8), device='meta')
    latents = torch.zeros((2, 32, 32), device='meta')
    ropes = torch.zeros((2, 32, 8), device='meta')
    before = mla_decode.KERNEL.launches
    with pytest.raises(ValueError, match='launches a CUDA kernel'):
        mla_decode.mla_decode_attention(q_eff, q_rope, latents, ropes,
                                        lengths, 0.1)
    assert mla_decode.KERNEL.launches == before
    before = mla_decode.PAGED_KERNEL.launches
    with pytest.raises(ValueError, match='launches a CUDA kernel'):
        mla_decode.paged_mla_decode_attention(
            q_eff, q_rope, latents.reshape(8, 8, 32), ropes.reshape(8, 8, 8),
            lengths, tables, 0.1)
    assert mla_decode.PAGED_KERNEL.launches == before
    # The gradient: its launcher raises on a non-CUDA device tensor, and
    # no backward launch is counted.
    q.requires_grad_(True)
    before = [kern.launches for kern in (flash_attention.DKV_KERNEL,
                                         flash_attention.DQ_KERNEL)]
    with pytest.raises(ValueError, match='launches a CUDA kernel'):
        flash_attention._flash_bwd(q, k, k, None, q, q,
                                   torch.zeros((1, 4, 64), device='meta'))
    assert [flash_attention.DKV_KERNEL.launches,
            flash_attention.DQ_KERNEL.launches] == before


def test_chip_smoke_fails_without_a_card_and_alone(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='')
    run = subprocess.run([sys.executable, str(REPO / 'chip_smoke.py')],
                         capture_output=True, text=True, env=env,
                         timeout=120)
    assert run.returncode != 0
    assert '"ok": true' not in run.stdout
    shutil.copy(REPO / 'chip_smoke.py', tmp_path / 'chip_smoke.py')
    alone = subprocess.run([sys.executable, 'chip_smoke.py'], cwd=tmp_path,
                           capture_output=True, text=True,
                           env=dict(env, PYTHONPATH=''), timeout=120)
    assert alone.returncode != 0
    assert '"ok": true' not in alone.stdout


def test_server_refuses_to_start_without_a_card(no_card):
    """The replica's entry point runs on the card: without one it raises,
    unless asked for the CPU."""
    from skypilot_tpu_torch.infer import server as server_lib
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        server_lib.main(['--model', 'tiny', '--port', '0'])
    replica = server_lib.build_replica(server_lib.parse_args(
        ['--model', 'tiny', '--device', 'cpu', '--port', '0',
         '--max-slots', '2', '--max-target-len', '64']), host='127.0.0.1')
    try:
        assert replica.engine.device.type == 'cpu'
    finally:
        replica.httpd.server_close()
        replica.loop.close()


@pytest.mark.parametrize('flags,item', [
    (['--mesh', 'sequence=2'], 'queue 1 item 8c'),
    (['--mesh', 'stage=2'], 'queue 1 item 8d'),
])
def test_server_flags_not_ported_yet_exit_naming_their_item(capsys, flags,
                                                            item):
    """The server serves under --mesh (item 8f); the mesh axes not ported
    yet still exit, naming their sub-item."""
    from skypilot_tpu_torch.infer import server as server_lib
    with pytest.raises(SystemExit) as exit_info:
        server_lib.parse_args(['--model', 'tiny'] + flags)
    assert exit_info.value.code == 2
    err = capsys.readouterr().err
    assert f'{flags[0]}: ' in err and 'not ported' in err and item in err
    assert server_lib.parse_args(['--model', 'tiny', '--mesh',
                                  'data=2']).mesh_plan.data == 2


def test_chip_smoke_quantized_phases_name_their_kernels():
    """Phases [13] and [14] hold the replica's path to K4 alone (its
    512-token prompts take the plain prefill attention, below the flash
    kernel's 1024); main runs [13], [14] and [15] after [12]."""
    import inspect
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from skypilot_tpu_torch.ops import attention
    assert chip_smoke.QUANT_SERVE_KERNELS == ('decode_attention',)
    assert chip_smoke.RUNG['prompt_len'] < attention._FLASH_MIN_SEQ
    assert chip_smoke.RUNG == dict(slots=16, max_len=2048, requests=32,
                                   prompt_len=512, new_tokens=128,
                                   decode_steps=16)
    body = inspect.getsource(chip_smoke.quantized_replica)
    assert 'zero_launches()' in body
    assert 'QUANT_SERVE_KERNELS,' in body and 'check_launches(' in body
    main = inspect.getsource(chip_smoke.main)
    order = [main.index(call) for call in (
        'small_deepseek_end_to_end()', "quantized_replica(records, 'int8')",
        "quantized_replica(records, 'int4')", 'small_quantized_end_to_end()')]
    assert order == sorted(order)


def test_chip_smoke_launch_phases_follow_the_quantized_ones():
    """Phases [16]-[19] run after [15], on the card; each launcher run of
    [16] and [17] zeroes the launch counts just before it and checks the
    training kernels just after; [18] checks K1 and K4 on the served
    path alone, before its comparison run builds an engine."""
    import inspect
    sys.path.insert(0, str(REPO))
    import chip_smoke
    body = inspect.getsource(chip_smoke.launch_run)
    assert body.index('zero_launches()') < body.index('launch.run(') < \
        body.index('check_launches(')
    for phase in (chip_smoke.launch_main_path, chip_smoke.lora_main_path,
                  chip_smoke.hf_checkpoint_path):
        assert "'--device', 'cuda'" in inspect.getsource(phase)
    assert chip_smoke.HF_SERVE_KERNELS == ('flash_fwd', 'decode_attention')
    hf = inspect.getsource(chip_smoke.hf_checkpoint_path)
    assert hf.index('zero_launches()') < hf.index('build_replica(') < \
        hf.index('/generate') < hf.index('check_launches(') < \
        hf.index('replica.loop.close()') < hf.index('InferenceEngine(')
    main = inspect.getsource(chip_smoke.main)
    order = [main.index(call) for call in (
        'small_quantized_end_to_end()',
        'launch_main_path(records, train_result)',
        'lora_main_path(records)', 'hf_checkpoint_path(records)',
        'small_launch_checks()')]
    assert order == sorted(order)


def test_chip_smoke_qwen_phases_follow_the_launch_checks():
    """Phases [20]-[22] run after [19], on the card. [20] counts the
    launches of its served requests alone (zeroed after the replica's
    build and warm-up, read before the comparison run and before the
    loop closes) and holds them to K1 and K4; [21] zeroes its counts just
    before it serves and checks them just after."""
    import inspect
    sys.path.insert(0, str(REPO))
    import chip_smoke
    replica = inspect.getsource(chip_smoke.qwen_replica)
    assert "'--device', 'cuda'" in replica
    assert replica.index('build_replica(') < replica.index(
        'zero_launches()') < replica.index('/generate') < replica.index(
        'check_launches(') < replica.index('.generate(') < replica.index(
        'replica.loop.close()')
    assert 'SERVE_KERNELS,' in replica
    direct = inspect.getsource(chip_smoke.qwen2_main_path)
    assert direct.index('zero_launches()') < direct.index(
        'serve_and_check(') < direct.index('check_launches(')
    assert chip_smoke.SERVE_KERNELS == ('flash_fwd', 'decode_attention')
    main = inspect.getsource(chip_smoke.main)
    order = [main.index(call) for call in (
        'small_launch_checks()', 'qwen_replica(records)',
        'qwen2_main_path(records)', 'small_qwen_end_to_end()',
        "print(json.dumps({'ok': True")]
    assert order == sorted(order)


def test_chip_smoke_speculative_phases_check_their_derived_launches():
    """Phases [23]-[25] run after [22], on the card. The served runs of
    [23] and [24] count their plain rounds and zero the launch counts
    after the replica's warm-up, then hold every kernel to the count
    derived from their prefills and rounds before any comparison run;
    [24]'s self-draft does the same around its drain."""
    import inspect
    sys.path.insert(0, str(REPO))
    import chip_smoke
    serve = inspect.getsource(chip_smoke.serve_speculative)
    assert serve.index('count_plain_rounds(') < serve.index(
        'zero_launches()') < serve.index('/generate') < serve.index(
        'check_derived_launches(') < serve.index('.generate(')
    for phase in (chip_smoke.spec_qwen_replica, chip_smoke.draft_model_paths):
        body = inspect.getsource(phase)
        assert body.index('serve_speculative(') < body.index(
            'plain_streams(') < body.index('check_ties(')
    ngram = inspect.getsource(chip_smoke.spec_qwen_replica)
    assert "'--spec-ngram'" in ngram and "'--device', 'cuda'" in ngram
    draft = inspect.getsource(chip_smoke.draft_model_paths)
    assert draft.index("'--draft-model', 'llama3-1b'") < draft.index(
        'serve_speculative(') < draft.index('zero_launches()') < \
        draft.index('serve_and_check(') < draft.index(
        'check_derived_launches(')
    assert 'SERVE_KERNELS' in inspect.getsource(
        chip_smoke.small_speculative_end_to_end)
    main = inspect.getsource(chip_smoke.main)
    order = [main.index(call) for call in (
        'small_qwen_end_to_end()', 'spec_qwen_replica(records, plain_qwen)',
        'draft_model_paths(records)', 'small_speculative_end_to_end()',
        "print(json.dumps({'ok': True")]
    assert order == sorted(order)


def test_derived_launch_check_and_round_counter():
    """check_derived_launches accepts the exact counts only, and
    count_plain_rounds counts each plain round of the wrapped tick."""
    sys.path.insert(0, str(REPO))
    import chip_smoke
    chip_smoke.check_derived_launches('p', {'a': 36, 'b': 0}, {'a': 36})
    for launches in ({'a': 35, 'b': 0}, {'a': 36, 'b': 1}):
        with pytest.raises(AssertionError):
            chip_smoke.check_derived_launches('p', launches, {'a': 36})

    class Orch:
        ticks = 0

        def _decode_tick(self):
            self.ticks += 1

    orch = Orch()
    rounds = chip_smoke.count_plain_rounds(orch)
    orch._decode_tick()
    orch._decode_tick()
    assert rounds == [2] and orch.ticks == 2


def test_gemma_entry_points_raise_without_a_card(no_card):
    """The Gemma family's init and a Gemma replica, like every entry
    point: the card unless the caller asks for the CPU."""
    from skypilot_tpu_torch.infer import server as server_lib
    from skypilot_tpu_torch.models import gemma
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        gemma.init(gemma.GEMMA2_TINY)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        server_lib.build_replica(server_lib.parse_args(
            ['--model', 'gemma2-tiny', '--port', '0']), host='127.0.0.1')
    params = gemma.init(gemma.GEMMA2_TINY, device='cpu')
    assert params['embed'].device.type == 'cpu'


def test_chip_smoke_gemma_phases_check_their_derived_launches():
    """Phases [26] and [27] run after [25], on the card. [26] counts its
    flash waves and decode steps and zeroes the launch counts after the
    replica's warm-up, then holds K1 and K4 to the counts derived from
    them (every other kernel to 0) before the comparison run; phase [3]
    holds K1, K4 and K5 at D 256 and puts their numbers in the kernels
    line."""
    import inspect
    sys.path.insert(0, str(REPO))
    import chip_smoke
    replica = inspect.getsource(chip_smoke.gemma2_replica)
    assert "'gemma2-9b'" in replica and "'--device', 'cuda'" in replica
    assert replica.index('build_replica(') < replica.index(
        'count_decode_steps(') < replica.index('count_flash_waves(') < \
        replica.index('zero_launches()') < replica.index('/generate') < \
        replica.index('check_derived_launches(') < replica.index(
        '.generate(') < replica.index('replica.loop.close()')
    assert chip_smoke.GEMMA_SERVE['max_len'] == 8192
    assert 'SERVE_KERNELS' in inspect.getsource(
        chip_smoke.small_gemma_end_to_end)
    assert "'d256': gemma" in inspect.getsource(chip_smoke.check_flash)
    assert "'d256': gemma" in inspect.getsource(chip_smoke.check_decode)
    assert 'd256_max_abs_err' in inspect.getsource(
        chip_smoke.check_paged_decode)
    main = inspect.getsource(chip_smoke.main)
    order = [main.index(call) for call in (
        'small_speculative_end_to_end()', 'gemma2_replica(records)',
        'small_gemma_end_to_end()', "print(json.dumps({'ok': True")]
    assert order == sorted(order)


def test_flash_wave_counter_counts_the_flash_buckets_only():
    """count_flash_waves counts a prefill forward only where its bucket
    reaches the flash kernel's shortest sequence."""
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from skypilot_tpu_torch.ops import attention

    class Engine:
        def _prefill_batch(self, tokens, *args):
            return tokens.shape[1]

    engine = Engine()
    waves = chip_smoke.count_flash_waves(engine)
    for bucket in (128, attention._FLASH_MIN_SEQ, 2048):
        engine._prefill_batch(torch.zeros((2, bucket)), None)
    assert waves == [2]


def test_chip_smoke_gemma_training_phases_check_their_derived_launches():
    """Phases [28] and [29] run after [27], on the card. [28] runs
    train/launch.py with Gemma2-2B's flags through launch_run (the launch
    counts zeroed just before each run and read just after) and holds
    K1-K3 of each run to the counts derived from its steps; [29] wants
    K1-K3 and nothing else on the card; phase [3] puts K2 and K3 at D 256
    in the kernels line."""
    import inspect
    sys.path.insert(0, str(REPO))
    import chip_smoke
    r = chip_smoke.GEMMA_TRAIN
    assert (r['model'], r['seq'], r['batch']) == ('gemma2-2b', 8192, 1)
    body = inspect.getsource(chip_smoke.gemma_train_path)
    for flag in ("'--device', 'cuda'", "'--optimizer', 'adafactor'",
                 "'--resume', 'auto'", "'--checkpoint-dir'"):
        assert flag in body
    assert body.index('launch_run(') < body.index('check_derived_launches(')
    assert 'TRAIN_KERNELS' in inspect.getsource(
        chip_smoke.small_gemma_train_checks)
    assert "records[name]['d256'] = gemma[name]" in inspect.getsource(
        chip_smoke.check_flash_bwd)
    main = inspect.getsource(chip_smoke.main)
    order = [main.index(call) for call in (
        'small_gemma_end_to_end()', 'gemma_train_path(records)',
        'small_gemma_train_checks()', "print(json.dumps({'ok': True")]
    assert order == sorted(order)


def test_build_report_names_the_head_dim_256_backward():
    """Phase [2] reports registers and spills of the flash backward's
    D 256 instantiations, the wgmma and the fp32 FMA ones alike, and only
    the FMA kernels at D 256."""
    sys.path.insert(0, str(REPO))
    import chip_smoke
    prefix = '_ZN45_GLOBAL__N__0_12_flash_bwd_cu_0'

    def entry(name, regs, spill):
        return (f"ptxas info    : Compiling entry function '{prefix}{name}"
                f"EEEvN4xsky11FlashParamsE' for 'sm_90a'\n"
                f'    0 bytes stack frame, {spill} bytes spill stores, '
                f'{spill} bytes spill loads\n'
                f'ptxas info    : Used {regs} registers\n')

    log = ''.join(entry(*e) for e in (
        ('2wg26flash_bwd_dkv_wgmma_kernelILi256', 168, 0),
        ('23flash_bwd_dq_fma_kernelILi256', 113, 0),
        ('24flash_bwd_dkv_fma_kernelILi256', 128, 8),
        ('24flash_bwd_dkv_fma_kernelILi128', 167, 0)))
    assert list(chip_smoke.hopper_kernels(log)) == [
        ('flash_bwd_dkv_wgmma_kernel<256>', 168, 0),
        ('flash_bwd_dq_fma_kernel<256>', 113, 0),
        ('flash_bwd_dkv_fma_kernel<256>', 128, 8)]


def test_mixtral_entry_points_raise_without_a_card(no_card):
    """The Mixtral family's init, its converter and a Mixtral replica,
    like every entry point: the card unless the caller asks for the
    CPU."""
    from skypilot_tpu_torch.infer import server as server_lib
    from skypilot_tpu_torch.models import moe
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        moe.init(moe.MOE_TINY)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        moe.init(moe.MOE_TINY, weight_dtype=torch.int8)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        server_lib.build_replica(server_lib.parse_args(
            ['--model', 'moe-tiny', '--weight-dtype', 'int8', '--port',
             '0']), host='127.0.0.1')
    params = moe.init(moe.MOE_TINY, device='cpu', weight_dtype=torch.int8)
    assert params['layers']['w_gate'].device.type == 'cpu'
    engine = engine_lib.InferenceEngine(engine_lib.EngineConfig(
        model=moe.MOE_TINY, max_slots=2, max_target_len=32,
        prefill_buckets=(16,), weight_dtype=torch.int8), params,
        device='cpu')
    assert engine.device.type == 'cpu'


@pytest.mark.parametrize('name', ['moe-tiny', 'deepseek-tiny'])
def test_routed_trainers_raise_without_a_card(no_card, name):
    """Mixtral and DeepSeek training, like every entry point: the
    Trainer, measure_throughput and the launcher run on the card unless
    the caller asks for the CPU."""
    from skypilot_tpu_torch import models
    from skypilot_tpu_torch.train import launch
    cfg = trainer.TrainConfig(model=models.get_config(name),
                              global_batch_size=2, seq_len=8)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        trainer.Trainer(cfg)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        trainer.measure_throughput(trainer.Trainer(cfg), num_steps=1)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        launch.main(['--model', name, '--steps', '1'])
    tr = trainer.Trainer(cfg, device='cpu')
    assert tr.device.type == 'cpu'
    _, metrics = tr.step(tr.init_state(), tr.synthetic_batch())
    assert torch.isfinite(metrics['loss'])


def test_chip_smoke_mixtral_phases_check_their_derived_launches():
    """Phases [30] and [31] run after [29], on the card. [30] builds
    Mixtral-8x7B's int8 replica as serve_mixtral.yaml sizes it (the
    build's peak memory measured around the init), counts its flash waves
    and decode steps, zeroes the launch counts after the warm-up, holds K1
    and K4 to the counts derived from them (every other kernel to 0)
    before the comparison run, and records the path as mixtral_serve;
    [31] wants K1 and K4 and nothing else on the card. [13] and [14] send
    one prompt alone, [14] fewer concurrent requests than [13], with
    every check."""
    import inspect
    sys.path.insert(0, str(REPO))
    import chip_smoke
    r = chip_smoke.MIXTRAL_SERVE
    assert (r['slots'], r['max_len'], r['requests']) == (16, 4096, 16)
    assert max(r['singles']) >= 3500 and r['prompt_len'] == (256, 1536)
    replica = inspect.getsource(chip_smoke.mixtral_replica)
    for flag in ("'mixtral-8x7b'", "'--weight-dtype', 'int8'",
                 "'--device', 'cuda'"):
        assert flag in replica
    assert replica.index('measured_init') < replica.index(
        'build_replica(') < replica.index('count_decode_steps(') < \
        replica.index('count_flash_waves(') < replica.index(
        'zero_launches()') < replica.index('/generate') < replica.index(
        'check_derived_launches(') < replica.index(
        "'mixtral_serve'") < replica.index(
        '.submit(orch_lib.Request(') < replica.index(
        'replica.loop.close()')
    assert 'SERVE_KERNELS' in inspect.getsource(
        chip_smoke.small_mixtral_end_to_end)
    assert chip_smoke.REPLICA_REQUESTS == {'int8': (1, 16), 'int4': (1, 16)}
    quantized = inspect.getsource(chip_smoke.quantized_replica)
    assert 'prompts[:n_singles]' in quantized and \
        'n_singles + n_requests' in quantized
    main = inspect.getsource(chip_smoke.main)
    order = [main.index(call) for call in (
        'small_gemma_train_checks()', 'mixtral_replica(records)',
        'small_mixtral_end_to_end()', "print(json.dumps({'ok': True")]
    assert order == sorted(order)


def test_chip_smoke_routed_training_phases_check_their_derived_launches():
    """Phases [32]-[34] run after [31], on the card. [32] trains
    Mixtral-8x7B's widths at 2 layers through the Trainer (launch counts
    zeroed just before the steps) and holds K1-K3 to the counts derived
    from layers x steps and the remat factor; [33] trains DeepSeek-V2-Lite
    at 4 layers and through the launcher with LoRA, and holds every
    kernel to 0; [34] wants K1-K3 and nothing else for moe-tiny and no
    kernel for DeepSeek; phase [3] puts K2 and K3 at Mixtral's heads in
    the kernels line."""
    import inspect
    sys.path.insert(0, str(REPO))
    import chip_smoke
    assert chip_smoke.MIXTRAL_TRAIN == dict(layers=2, seq=4096, batch=2,
                                            warmup=1, measured=3)
    assert chip_smoke.DEEPSEEK_TRAIN == dict(layers=4, seq=4096, batch=1,
                                             warmup=1, measured=3)
    assert chip_smoke.MIXTRAL_BWD == dict(b=2, s=4096, h=32, h_kv=8, d=128)
    steps = inspect.getsource(chip_smoke.train_routed)
    assert steps.index('zero_launches()') < steps.index('tr.step(') < \
        steps.index('kernels.REGISTRY')
    mixtral = inspect.getsource(chip_smoke.mixtral_train_path)
    assert mixtral.index('train_routed(') < mixtral.index(
        'check_derived_launches(') < mixtral.index("'mixtral_train'")
    ds = inspect.getsource(chip_smoke.deepseek_train_path)
    for flag in ("'deepseek-v2-lite'", "'--lora-rank'", "'--device', 'cuda'"):
        assert flag in ds
    assert ds.index('train_routed(') < ds.index('launch_run(') < ds.index(
        "check_derived_launches('deepseek_train (LoRA launch)'") < \
        ds.index("'deepseek_train'")
    assert 'TRAIN_KERNELS' in inspect.getsource(
        chip_smoke.small_routed_train_checks)
    assert "records[name]['mixtral'] = mixtral[name]" in inspect.getsource(
        chip_smoke.check_flash_bwd)
    main = inspect.getsource(chip_smoke.main)
    order = [main.index(call) for call in (
        'small_mixtral_end_to_end()', 'mixtral_train_path(records)',
        'deepseek_train_path(records)', 'small_routed_train_checks()',
        "print(json.dumps({'ok': True")]
    assert order == sorted(order)


def test_capture_aux_reads_each_loss_term_and_restores_the_function():
    """chip_smoke's capture_aux keeps the load-balance term each routed
    loss computes, with no other forward, and puts the function back."""
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from skypilot_tpu_torch.models import moe
    cfg = moe.MOE_TINY_F32
    params = moe.init(cfg, device='cpu')
    tokens = torch.arange(16).reshape(2, 8)
    real = moe.forward
    with chip_smoke.capture_aux(moe, 'forward') as aux:
        loss = moe.loss_fn(cfg, params, tokens, tokens)
        moe.forward(cfg, params, tokens)          # no term: not kept
    assert moe.forward is real and len(aux.values) == 1
    _, want = moe.forward(cfg, params, tokens, return_aux=True)
    assert torch.equal(aux.values[0], want)
    ce = loss - cfg.router_aux_coef * want
    assert torch.isfinite(ce) and float(want) > 0


def test_chip_smoke_mesh_phase_checks_every_rank():
    """Phases [37] and [38] run last, after [36]: the one-rank launcher
    in-process and gangs of rank processes, each gang started by one
    launcher (train/launch.py's main with --procs-per-host, its ranks
    running chip_smoke.mesh_rank), each rank zeroing the launch counts
    just before its launcher run and reading them just after; every
    rank's K1-K3 are held to the counts derived from its steps."""
    import inspect
    sys.path.insert(0, str(REPO))
    import chip_smoke
    r = chip_smoke.MESH_TRAIN
    assert (r['model'], r['batch'], r['seq']) == (
        'llama3-1b-qkvo_gup', 4, 4096)
    assert chip_smoke.mesh_models()[r['model']].n_layers == 16
    rank = inspect.getsource(chip_smoke.mesh_rank)
    assert rank.index('zero_launches()') < rank.index('launch.run(') < \
        rank.index('kernels.REGISTRY')
    assert 'ENV_LOCAL_RANK' in rank
    gang = inspect.getsource(chip_smoke.mesh_gang)
    for name in ('launch.main(', "'--procs-per-host'", "'RANK_COMMAND'",
                 'MESH_RANK_CODE'):
        assert name in gang
    expert = inspect.getsource(chip_smoke.expert_train_path)
    for flag in ('mesh_gang(', "procs=a['procs']", "procs=b['procs']",
                 'check_derived_launches(', "'launches_by_path'",
                 'resume_at_one_rank('):
        assert flag in expert
    assert (chip_smoke.EP_MIXTRAL['mesh'], chip_smoke.EP_MIXTRAL['procs'],
            chip_smoke.EP_DEEPSEEK['mesh'], chip_smoke.EP_DEEPSEEK['procs']
            ) == ('data=1,fsdp=1,expert=2', 2, 'data=1,fsdp=2,expert=2', 4)
    body = inspect.getsource(chip_smoke.mesh_train_path)
    for flag in ("'data=1,fsdp=2'", "'data=2'", "'--resume', 'auto'",
                 'check_derived_launches(', "'launches_by_path'"):
        assert flag in body
    assert chip_smoke.mesh_derived(3) == {
        'flash_fwd': 96, 'flash_bwd_dkv': 48, 'flash_bwd_dq': 48}
    main = inspect.getsource(chip_smoke.main)
    order = [main.index(call) for call in (
        'hooks_path(records)', 'mesh_train_path(records)',
        'expert_train_path(records)', "print(json.dumps({'ok': True")]
    assert order == sorted(order)


def test_chip_smoke_serving_mesh_phase_checks_every_rank():
    """Phase [39] runs last: each replica a gang that one server launcher
    starts (``--procs-per-host``, its ranks running
    chip_smoke.serve_rank, which reports through files), (a)
    serve_mixtral.yaml's at expert=2 against [30]'s outputs, (b) at
    data=2 x tensor=2 and (c) at data=2 x expert=2 beside one rank; every
    rank's kernels held to the counts derived from its own steps and
    waves, every rank's tokens and weight and cache bytes checked."""
    import inspect
    sys.path.insert(0, str(REPO))
    import chip_smoke
    assert (chip_smoke.MESH_SERVE_A['model'], chip_smoke.MESH_SERVE_A[
        'mesh'], chip_smoke.MESH_SERVE_A['procs']) == (
        'mixtral-8x7b', 'expert=2', 2)
    assert (chip_smoke.MESH_SERVE_B['mesh'], chip_smoke.MESH_SERVE_B[
        'procs'], chip_smoke.MESH_SERVE_C['mesh'],
        chip_smoke.MESH_SERVE_C['procs']) == (
        'data=2,tensor=2', 4, 'data=2,expert=2', 4)
    rank = inspect.getsource(chip_smoke.serve_rank)
    assert "'build_engine'" in rank and 'ENV_LOCAL_RANK' in rank
    watch = inspect.getsource(chip_smoke.RankWatch)
    assert watch.index('zero_launches()') < watch.index('kernels.REGISTRY')
    launcher = inspect.getsource(chip_smoke.serve_launcher)
    assert 'RANK_COMMAND' in launcher and 'SERVE_RANK_CODE' in launcher
    check = inspect.getsource(chip_smoke.check_mesh_ranks)
    for name in ('check_derived_launches(', 'expected_rank_bytes(',
                 "'kv_bytes'", "'tokens'"):
        assert name in check
    for phase in (chip_smoke.mesh_serve_mixtral, chip_smoke.mesh_serve_llama,
                  chip_smoke.mesh_serve_deepseek):
        body = inspect.getsource(phase)
        assert body.index('mesh_gang_serve(') < body.index(
            'check_mesh_ranks(') < body.index('held_logprobs(')
    assert 'gang.stop()' in inspect.getsource(chip_smoke.mesh_serve_mixtral)
    assert 'SIGKILL' in inspect.getsource(chip_smoke.mesh_serve_llama)
    main = inspect.getsource(chip_smoke.main)
    order = [main.index(call) for call in (
        'mixtral_replica(records)', 'expert_train_path(records)',
        'serve_mesh_path(records)', "print(json.dumps({'ok': True")]
    assert order == sorted(order)
