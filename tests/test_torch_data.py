"""The port's token pipeline vs the JAX package's, on the CPU.

* Both loader flavors (the pure-python twin and the native C++ loader,
  built by g++ from each package's own copy of ``dataloader.cc``) give
  the rows the JAX package's loader of the same flavor gives, for the
  same shards and seed, bit for bit: across shard boundaries, past an
  epoch, and for every host of a data-parallel gang (each epoch's
  samples split disjointly over the hosts, covering them all).
* ``skip`` lands where the same number of ``next`` calls does.
* ``batches`` gives the same tokens and targets (vocab clamp included),
  ``expand_data_arg`` the same shard lists, ``make_loader`` the same
  flavor rules, and ``prep`` the same shard bytes and summary.

Everything is exact (integers); no tolerance.
"""
from __future__ import annotations

import numpy as np
import pytest

from skypilot_tpu.train import data as jax_data
from skypilot_tpu.train import prep as jax_prep
from skypilot_tpu_torch.train import data
from skypilot_tpu_torch.train import prep


@pytest.fixture(scope='module')
def shards(tmp_path_factory):
    """Three shards of different lengths (uint32 tokens, some >= 2^31
    so the clamp matters)."""
    root = tmp_path_factory.mktemp('shards')
    rng = np.random.default_rng(0)
    paths = []
    for i, n in enumerate((1000, 337, 2050)):
        tokens = rng.integers(0, 300, n).astype(np.uint32)
        tokens[rng.random(n) < 0.01] = np.uint32(2**31 + 5)
        path = root / f'shard-{i}.bin'
        tokens.astype('<u4').tofile(path)
        paths.append(str(path))
    return paths


@pytest.fixture(scope='module', autouse=True)
def native_cache(tmp_path_factory):
    """One build cache for the module (both packages' sources are the
    same bytes, so they share one library)."""
    mp = pytest.MonkeyPatch()
    mp.setenv('XSKY_NATIVE_CACHE', str(tmp_path_factory.mktemp('native')))
    yield
    mp.undo()


def _rows(loader, n):
    try:
        return np.stack([next(loader) for _ in range(n)])
    finally:
        loader.close()


def test_native_source_is_the_reference_copy():
    assert data._SOURCE.endswith('skypilot_tpu_torch/native/dataloader.cc')
    with open(data._SOURCE, 'rb') as a, open(jax_data._SOURCE, 'rb') as b:
        assert a.read() == b.read()


@pytest.mark.parametrize('host_rank,num_hosts', [(0, 1), (0, 3), (2, 3)])
@pytest.mark.parametrize('flavor', ['python', 'native'])
def test_loader_rows_match_jax(shards, flavor, host_rank, num_hosts):
    kw = dict(batch=3, seq=16, seed=7, host_rank=host_rank,
              num_hosts=num_hosts, flavor=flavor, workers=1)
    mine = data.make_loader(shards, **kw)
    ref = jax_data.make_loader(shards, **kw)
    assert type(mine).__name__ == type(ref).__name__
    assert mine.n_samples == ref.n_samples == (3387 - 1) // 16
    # Past one epoch of this host's slice (211 samples / num_hosts).
    n = 80 if num_hosts == 1 else 30
    np.testing.assert_array_equal(_rows(mine, n), _rows(ref, n))


@pytest.mark.parametrize('flavor', ['python', 'native'])
def test_hosts_split_each_epoch_disjointly(shards, flavor):
    """Over one epoch the gang's hosts read every sample exactly once."""
    seq, n_hosts = 16, 3
    n_samples = (3387 - 1) // seq
    seen = []
    for rank in range(n_hosts):
        per_host = len(range(rank, n_samples, n_hosts))
        loader = data.make_loader(shards, batch=1, seq=seq, seed=3,
                                  host_rank=rank, num_hosts=n_hosts,
                                  flavor=flavor, workers=1)
        seen.append(_rows(loader, per_host)[:, 0])
    every = data.make_loader(shards, batch=n_samples, seq=seq, seed=3,
                             flavor='python')
    want = np.sort(np.asarray(next(every)).view(np.void), axis=0)
    got = np.sort(np.concatenate(seen).view(np.void), axis=0)
    assert got.shape[0] == n_samples
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('flavor', ['python', 'native'])
def test_skip_lands_where_next_does(shards, flavor):
    kw = dict(batch=4, seq=32, seed=1, flavor=flavor, workers=1)
    a = data.make_loader(shards, **kw)
    b = data.make_loader(shards, **kw)
    for _ in range(30):       # past the 105-sample epoch
        next(a)
    b.skip(30)
    np.testing.assert_array_equal(_rows(a, 5), _rows(b, 5))


def test_batches_match_jax(shards):
    kw = dict(batch=2, seq=24, seed=5, flavor='python')
    mine = data.batches(data.make_loader(shards, **kw), vocab_size=256)
    ref = jax_data.batches(jax_data.make_loader(shards, **kw),
                           vocab_size=256)
    for _ in range(10):
        got, want = next(mine), next(ref)
        assert set(got) == set(want) == {'tokens', 'targets'}
        for key in want:
            assert got[key].dtype == want[key].dtype == np.int32
            np.testing.assert_array_equal(got[key], want[key])
        assert got['tokens'].max() <= 255


def test_expand_data_arg_matches_jax(shards, tmp_path):
    root = str(shards[0]).rsplit('/', 1)[0]
    for spec in (root, f'{root}/shard-*.bin',
                 f'{shards[2]},{shards[0]}'):
        assert data.expand_data_arg(spec) == jax_data.expand_data_arg(spec)
    with pytest.raises(FileNotFoundError):
        data.expand_data_arg(str(tmp_path / 'none-*.bin'))


def test_flavor_rules_match_jax(shards, monkeypatch):
    """Without the native library: 'native' raises, 'auto' falls back to
    python on one host only."""
    for mod in (data, jax_data):
        monkeypatch.setattr(mod, 'build_native_lib', lambda: None)
    for mod in (data, jax_data):
        with pytest.raises(RuntimeError, match='native data loader '
                                               'unavailable'):
            mod.make_loader(shards, 2, 16, flavor='native')
        assert isinstance(mod.make_loader(shards, 2, 16, flavor='auto'),
                          mod.PyTokenLoader)
        with pytest.raises(RuntimeError, match='Multi-host runs'):
            mod.make_loader(shards, 2, 16, flavor='auto', num_hosts=2)
        with pytest.raises(ValueError, match='flavor'):
            mod.make_loader(shards, 2, 16, flavor='mmap')


def test_prep_writes_the_same_shards(tmp_path, capsys):
    docs = []
    for i, text in enumerate(('hello world\n', 'ünïcödé ✓ text',
                              '', 'third document ' * 20)):
        path = tmp_path / f'doc{i}.txt'
        path.write_text(text, encoding='utf-8')
        docs.append(str(path))
    outs = {}
    for name, mod in (('port', prep), ('jax', jax_prep)):
        out = tmp_path / f'{name}.bin'
        assert mod.main(docs + ['--out', str(out), '--vocab-size',
                                '512']) == 0
        outs[name] = (out.read_bytes(), capsys.readouterr().out)
    assert outs['port'][0] == outs['jax'][0]
    assert outs['port'][1].replace('port.bin', 'X') == \
        outs['jax'][1].replace('jax.bin', 'X')
    tokens = np.frombuffer(outs['port'][0], '<u4')
    assert (tokens == 2).sum() == 3   # one EOS per non-empty document
    from skypilot_tpu.infer import tokenizer as jax_tokenizer
    from skypilot_tpu_torch.infer import tokenizer
    for mod, tok in ((prep, tokenizer), (jax_prep, jax_tokenizer)):
        with pytest.raises(ValueError, match='does not fit'):
            mod.prep_files(docs, str(tmp_path / 'x.bin'),
                           tok.ByteTokenizer(512), vocab_size=200)
