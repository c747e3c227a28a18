"""The port's server under a mesh: one ``--procs-per-host`` launcher
starting a gang of rank processes on the CPU.

``python -m skypilot_tpu_torch.infer.server --device cpu --procs-per-host
2 --mesh tensor=2`` (here through ``python -c`` with a test model
registered: an fp32 tiny Llama with a 512-token vocabulary, so that the
byte tokenizer fits) answers ``/generate`` (greedy and sampled) and
``/v1/completions`` as a one-process server at the same seed does;
``/health`` answers only once every rank is up and warm; an idle gang
still answers after waiting longer than its collective timeout (the
ranks' ``distributed.TIMEOUT`` cut to 3 s through the module's
constant); SIGTERM to the launcher ends every rank, and a SIGKILLed
follower fails the request in flight and the gang with 137, leaving no
process. ``--hf-checkpoint`` on a tiny HF Llama that the test writes
serves under ``--mesh tensor=2`` the tokens one process serves (both
converted in fp32). The refusals are checked by their texts.

Tolerances: tokens and completion texts identical (fp32; the tensor
split adds partial sums in another order, which moves no greedy token of
these prompts). Every test runs under its own 120 s SIGALRM, every HTTP
call has a timeout, and every process is reaped in ``finally``.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from skypilot_tpu_torch.infer import server as server_lib
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models import llama

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEST_LIMIT_S = 120
HTTP_TIMEOUT_S = 30
START_S = 60
COLLECTIVE_TIMEOUT_S = 3
MODEL = 'tiny-512-f32'
CONFIG = dataclasses.replace(llama.LLAMA_TINY, vocab_size=512,
                             dtype=torch.float32)
FLAGS = ['--model', MODEL, '--device', 'cpu', '--max-slots', '4',
         '--max-target-len', '64']
# The script every process of a test server runs (the launcher, and its
# ranks as RANK_COMMAND): the test model registered, the collective
# timeout cut, one rank's engine build slowed (``XSKY_TEST_SLOW_RANK``;
# by less than that timeout, which rank 0's first collective waits),
# HF conversion in fp32, then the server's main.
CODE = f'''
import dataclasses, datetime, functools, os, sys, time
sys.path.insert(0, {REPO!r})
import torch
from skypilot_tpu_torch.parallel import distributed
from skypilot_tpu_torch.models import convert, llama
from skypilot_tpu_torch.infer import server
distributed.TIMEOUT = datetime.timedelta(seconds={COLLECTIVE_TIMEOUT_S})
llama.CONFIGS[{MODEL!r}] = dataclasses.replace(
    llama.LLAMA_TINY, vocab_size=512, dtype=torch.float32)
convert.from_hf = functools.partial(convert.from_hf, dtype=torch.float32)
slow = os.environ.get('XSKY_TEST_SLOW_RANK')
if slow and os.environ.get(distributed.ENV_LOCAL_RANK) == slow:
    build = server.build_engine
    server.build_engine = lambda args: (
        time.sleep(float(os.environ['XSKY_TEST_SLOW_S'])), build(args))[1]
server.RANK_COMMAND = (os.path.abspath(__file__),)
sys.exit(server.main())
'''


@pytest.fixture(autouse=True)
def _time_limit():
    def expire(signum, frame):
        del signum, frame
        raise TimeoutError(f'test ran past its {TEST_LIMIT_S} s limit')

    previous = signal.signal(signal.SIGALRM, expire)
    signal.alarm(TEST_LIMIT_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, previous)


@pytest.fixture(autouse=True)
def _state_db(monkeypatch, tmp_path):
    monkeypatch.setenv('XSKY_STATE_DB', str(tmp_path / 'state.db'))


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        return sock.getsockname()[1]


def _call(url, path, body=None):
    """(status, parsed JSON) of one request."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url + path, data=data, headers={
        'Content-Type': 'application/json'})
    try:
        with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT_S) as resp:
            return resp.status, json.loads(resp.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _children(pid: int):
    try:
        with open(f'/proc/{pid}/task/{pid}/children') as f:
            return [int(p) for p in f.read().split()]
    except OSError:
        return []


def _alive(pid: int) -> bool:
    """Whether ``pid`` runs (a zombie does not)."""
    try:
        with open(f'/proc/{pid}/stat') as f:
            return f.read().rsplit(')', 1)[1].split()[0] != 'Z'
    except OSError:
        return False


class Gang:
    """One launcher (``server.main`` with ``--procs-per-host 2``) and its
    rank processes; :meth:`close` kills whatever is left."""

    def __init__(self, flags, tmp_path, env=None) -> None:
        self.port = _free_port()
        self.url = f'http://127.0.0.1:{self.port}'
        self.log = open(tmp_path / f'gang-{self.port}.log', 'w')
        script = tmp_path / 'serve.py'
        script.write_text(CODE)
        self.proc = subprocess.Popen(
            [sys.executable, str(script), *flags, '--procs-per-host', '2',
             '--port', str(self.port)],
            cwd=REPO, stdout=self.log, stderr=subprocess.STDOUT,
            env=dict(os.environ, OMP_NUM_THREADS='1', **(env or {})))
        self.ranks = []

    def wait_healthy(self, timeout: float = START_S) -> float:
        """Seconds until /health answered 200 (the rank pids noted)."""
        start = time.monotonic()
        while time.monotonic() - start < timeout:
            assert self.proc.poll() is None, self.tail()
            try:
                if _call(self.url, '/health')[0] == 200:
                    self.ranks = _children(self.proc.pid)
                    return time.monotonic() - start
            except OSError:
                pass
            time.sleep(0.2)
        raise AssertionError(f'no /health in {timeout} s\n{self.tail()}')

    def tail(self) -> str:
        self.log.flush()
        with open(self.log.name) as f:
            return f.read()[-4000:]

    def close(self) -> None:
        pids = _children(self.proc.pid)
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        for pid in pids:
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        self.log.close()


def _one_process(flags, monkeypatch):
    """The same replica in this process, one rank, no mesh."""
    monkeypatch.setitem(llama.CONFIGS, MODEL, CONFIG)
    replica = server_lib.build_replica(
        server_lib.parse_args(flags + ['--port', '0']), host='127.0.0.1')
    threading.Thread(target=replica.httpd.serve_forever, daemon=True).start()
    return replica, f'http://127.0.0.1:{replica.httpd.server_address[1]}'


def _close(replica):
    replica.httpd.shutdown()
    replica.httpd.server_close()
    replica.loop.close()


BODIES = [
    ('/generate', {'prompt_tokens': [1, 2, 3], 'max_new_tokens': 8}),
    ('/generate', {'prompt_tokens': list(range(5, 40)),
                   'max_new_tokens': 6}),
    ('/generate', {'prompt_tokens': [9, 8, 7, 6], 'max_new_tokens': 8,
                   'temperature': 0.8, 'top_p': 0.9}),
    ('/v1/completions', {'prompt': 'hello', 'max_tokens': 8}),
    ('/v1/completions', {'prompt': 'xsky', 'max_tokens': 4,
                         'logprobs': 2}),
]


def _answer(url, path, body):
    status, payload = _call(url, path, body)
    assert status == 200, payload
    if path == '/generate':
        return payload['output_tokens']
    return [(c['text'], c.get('logprobs') and [
        round(v, 4) for v in c['logprobs']['token_logprobs']])
        for c in payload['choices']]


@pytest.fixture(scope='module')
def gang(tmp_path_factory):
    """A tensor=2 gang whose follower builds its engine 2 s late."""
    g = Gang(FLAGS + ['--mesh', 'tensor=2'], tmp_path_factory.mktemp('g'),
             env={'XSKY_TEST_SLOW_RANK': '1', 'XSKY_TEST_SLOW_S': '2'})
    try:
        yield g
    finally:
        g.close()


def test_health_waits_for_every_rank(gang):
    """The follower builds its engine 2 s late: until it is up and warm
    nothing answers, then /health does, from rank 0 alone, with both
    ranks alive."""
    assert gang.wait_healthy() >= 2.0
    assert len(gang.ranks) == 2 and all(_alive(p) for p in gang.ranks)
    assert _call(gang.url, '/health')[1]['max_slots'] == 4


def test_gang_answers_as_one_process(gang, monkeypatch):
    """/generate (greedy, a prompt past the largest bucket, sampled) and
    /v1/completions with the byte tokenizer (text, logprobs) equal a
    one-process server's at the same seed."""
    gang.wait_healthy()
    replica, url = _one_process(FLAGS, monkeypatch)
    try:
        for path, body in BODIES:
            assert _answer(gang.url, path, body) == _answer(url, path, body)
    finally:
        _close(replica)


def test_an_idle_gang_answers_past_its_collective_timeout(gang):
    """Followers wait for rank 0's next call on the store, without a
    limit: after an idle stretch longer than the ranks' collective
    timeout the gang still answers, the same tokens."""
    gang.wait_healthy()
    path, body = BODIES[0]
    before = _answer(gang.url, path, body)
    time.sleep(COLLECTIVE_TIMEOUT_S + 2)
    assert _answer(gang.url, path, body) == before
    assert all(_alive(p) for p in gang.ranks)


def test_sigterm_to_the_launcher_ends_every_rank(gang):
    gang.wait_healthy()
    gang.proc.send_signal(signal.SIGTERM)
    assert gang.proc.wait(timeout=30) == 128 + signal.SIGTERM
    deadline = time.monotonic() + 10
    while any(_alive(p) for p in gang.ranks) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert not any(_alive(p) for p in gang.ranks)


def test_a_killed_follower_fails_the_request_and_the_gang(tmp_path):
    """SIGKILL to the follower while a request decodes: the launcher ends
    the gang with 137 (the follower's code) and the request fails, well
    inside the collective timeout's multiples; no process is left."""
    g = Gang(FLAGS + ['--mesh', 'tensor=2', '--decode-steps', '1'],
             tmp_path)
    try:
        g.wait_healthy()
        outcome = []

        def request():
            try:
                outcome.append(_call(g.url, '/generate', {
                    'prompt_tokens': [1, 2, 3], 'max_new_tokens': 60}))
            except OSError as e:          # the connection dropped
                outcome.append(e)
        t = threading.Thread(target=request, daemon=True)
        t.start()
        time.sleep(0.3)
        os.kill(g.ranks[1], signal.SIGKILL)
        assert g.proc.wait(timeout=30) == 128 + signal.SIGKILL
        t.join(HTTP_TIMEOUT_S)
        assert outcome, 'the request hung'
        assert isinstance(outcome[0], OSError) or outcome[0][0] != 200
        assert not any(_alive(p) for p in g.ranks)
    finally:
        g.close()


def test_hf_checkpoint_serves_under_a_tensor_split(tmp_path, monkeypatch):
    """A tiny HF Llama written with ``save_pretrained``, converted in
    fp32 by each rank and cut to its blocks, serves under ``--mesh
    tensor=2`` the greedy tokens one process serves from it."""
    import transformers
    cfg = transformers.LlamaConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128, rms_norm_eps=1e-5,
        tie_word_embeddings=False)
    torch.manual_seed(0)
    ckpt = tmp_path / 'tiny-hf-llama'
    transformers.LlamaForCausalLM(cfg).save_pretrained(ckpt)
    flags = ['--hf-checkpoint', str(ckpt), '--device', 'cpu',
             '--max-slots', '2', '--max-target-len', '64']
    g = Gang(flags + ['--mesh', 'tensor=2'], tmp_path)
    monkeypatch.setattr(convert, 'from_hf', functools.partial(
        convert.from_hf, dtype=torch.float32))
    replica = None
    try:
        replica, url = _one_process(flags, monkeypatch)
        g.wait_healthy()
        for prompt in ([1, 2, 3], [200, 17, 5, 9, 44, 101, 7]):
            body = {'prompt_tokens': prompt, 'max_new_tokens': 8}
            assert (_answer(g.url, '/generate', body)
                    == _answer(url, '/generate', body))
    finally:
        g.close()
        if replica is not None:
            _close(replica)


@pytest.mark.parametrize('flags,text', [
    (['--model', 'tiny', '--kv-page-size', '16', '--mesh', 'tensor=2'],
     'the paged cache'),
    (['--model', 'mixtral-8x7b', '--mesh', 'tensor=2'],
     'queue 1 item 8b-ii'),
    (['--model', 'deepseek-tiny', '--mesh', 'expert=2,tensor=2'],
     'queue 1 item 8b-ii'),
    (['--model', 'tiny', '--mesh', 'sequence=2'], 'queue 1 item 8c'),
    (['--model', 'tiny', '--mesh', 'stage=2'], 'queue 1 item 8d'),
    (['--model', 'tiny', '--mesh', 'tensor=2', '--spec-ngram'],
     'queue 1 item 8f-ii'),
    (['--model', 'tiny', '--mesh', 'tensor=2', '--draft-model', 'tiny'],
     'queue 1 item 8f-ii'),
    (['--model', 'tiny', '--mesh', 'widgets=2'], 'Unknown mesh axis'),
], ids=['paged', 'mixtral-tensor', 'deepseek-tensor', 'sequence', 'stage',
        'spec-ngram', 'draft-model', 'unknown-axis'])
def test_unported_meshes_are_refused_by_name(flags, text, capsys):
    with pytest.raises(SystemExit):
        server_lib.parse_args(flags)
    assert text in capsys.readouterr().err


def test_uneven_slots_fail_the_gang_naming_the_split(tmp_path):
    """--max-slots 3 over data=2: each rank refuses when its engine is
    built, and the launcher exits with the failing rank's code."""
    g = Gang(['--model', 'tiny', '--device', 'cpu', '--max-slots', '3',
              '--max-target-len', '64', '--mesh', 'data=2'], tmp_path)
    try:
        assert g.proc.wait(timeout=START_S) == 1
        assert 'max_slots 3 does not split into 2 equal blocks' in g.tail()
    finally:
        g.close()
