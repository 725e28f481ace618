"""The public names of the JAX package that the port also exports
(``Config`` and ``__version__`` at the top level, ``Config.to_dict``,
``HashedFeatureEncoder`` from ``distlr_tpu_torch.data``, ``check`` /
``check_eq`` / ``CheckError`` from ``distlr_tpu_torch.utils``), each held
to the JAX package's on the same inputs."""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import distlr_tpu
import distlr_tpu_torch
from distlr_tpu.data import HashedFeatureEncoder as JaxEncoder
from distlr_tpu.utils import check as jax_check
from distlr_tpu.utils import check_eq as jax_check_eq
from distlr_tpu.utils.logging import CheckError as JaxCheckError
from distlr_tpu_torch.data import HashedFeatureEncoder
from distlr_tpu_torch.utils import CheckError, check, check_eq

REPO = Path(__file__).resolve().parents[1]


def _ids(seed: int, rows: int = 37, fields: int = 6):
    """Seeded 64-bit raw ids (negative and huge ones among them), their
    field ids and values."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(-(2**62), 2**62, size=(rows, fields), dtype=np.int64)
    raw[:, 0] = rng.integers(0, 50, size=rows)  # recurring small ids
    field_ids = np.broadcast_to(np.arange(fields), (rows, fields))
    vals = rng.standard_normal((rows, fields)).astype(np.float32)
    return field_ids, raw, vals


@pytest.mark.parametrize("signed", [False, True], ids=["unsigned", "signed"])
@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("buckets", [32, 1000, 1 << 20])
def test_encode_coo_equals_jax(seed, signed, buckets):
    field_ids, raw, vals = _ids(seed)
    ours = HashedFeatureEncoder(num_buckets=buckets, seed=seed, signed=signed)
    theirs = JaxEncoder(num_buckets=buckets, seed=seed, signed=signed)
    for raw_vals in (None, vals):
        (c, v), (jc, jv) = ours.encode_coo(field_ids, raw, raw_vals), \
            theirs.encode_coo(field_ids, raw, raw_vals)
        assert c.dtype == jc.dtype and v.dtype == jv.dtype
        assert c.tobytes() == jc.tobytes() and v.tobytes() == jv.tobytes()
        assert c.min() >= 0 and c.max() < buckets


@pytest.mark.parametrize("signed", [False, True], ids=["unsigned", "signed"])
@pytest.mark.parametrize("seed", [0, 3])
def test_encode_dense_equals_jax(seed, signed):
    field_ids, raw, vals = _ids(seed, rows=9)
    ours = HashedFeatureEncoder(num_buckets=64, seed=seed, signed=signed)
    theirs = JaxEncoder(num_buckets=64, seed=seed, signed=signed)
    X, JX = ours.encode_dense(field_ids, raw, vals), theirs.encode_dense(field_ids, raw, vals)
    assert X.shape == (9, 64) and X.dtype == JX.dtype == np.float32
    assert X.tobytes() == JX.tobytes()


@pytest.mark.parametrize("signed", [False, True], ids=["unsigned", "signed"])
@pytest.mark.parametrize("seed", [0, 5])
def test_encode_csr_equals_jax(seed, signed):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, 8, size=20)
    row_ptr = np.concatenate([[0], np.cumsum(lengths)])
    cols = rng.integers(0, 2**40, size=int(row_ptr[-1]), dtype=np.int64)
    vals = rng.standard_normal(cols.shape[0]).astype(np.float32)
    ours = HashedFeatureEncoder(num_buckets=100, seed=seed, signed=signed)
    theirs = JaxEncoder(num_buckets=100, seed=seed, signed=signed)
    rp, c, v = ours.encode_csr(row_ptr, cols, vals)
    jrp, jc, jv = theirs.encode_csr(row_ptr, cols, vals)
    np.testing.assert_array_equal(rp, jrp)
    assert c.tobytes() == jc.tobytes() and v.tobytes() == jv.tobytes()


def test_encoder_is_a_frozen_dataclass_like_jax():
    fields = [(f.name, f.default) for f in dataclasses.fields(HashedFeatureEncoder)]
    assert fields == [(f.name, f.default) for f in dataclasses.fields(JaxEncoder)]
    with pytest.raises(dataclasses.FrozenInstanceError):
        HashedFeatureEncoder(8).seed = 1


def test_config_to_dict_equals_jax_on_shared_fields():
    from distlr_tpu.config import Config as JaxConfig

    from distlr_tpu_torch.config import Config

    kw = {"num_feature_dim": 1000, "learning_rate": 0.5, "num_workers": 2, "num_servers": 3,
          "sync_mode": False, "batch_size": 64, "l2_c": 0.0, "random_seed": 3}
    ours, theirs = Config(**kw).to_dict(), JaxConfig(**kw).to_dict()
    shared = set(ours) & set(theirs)
    assert set(kw) <= shared and len(shared) > 50
    assert {k: ours[k] for k in shared} == {k: theirs[k] for k in shared}
    assert ours == dataclasses.asdict(Config(**kw))
    assert Config(**ours) == Config(**kw)  # the dict rebuilds the config


@pytest.mark.parametrize("msg", ["", "rank out of range", "x=3"])
def test_check_messages_equal_jax(msg):
    check(True, msg)
    with pytest.raises(CheckError) as ours:
        check(False, msg)
    with pytest.raises(JaxCheckError) as theirs:
        jax_check(False, msg)
    assert str(ours.value) == str(theirs.value) == f"Check failed: {msg}"


@pytest.mark.parametrize("a,b,msg", [(1, 2, ""), ("x", "y", "keys"), ((1, 2), [1, 2], "dims")])
def test_check_eq_messages_equal_jax(a, b, msg):
    check_eq(a, a, msg)
    with pytest.raises(CheckError) as ours:
        check_eq(a, b, msg)
    with pytest.raises(JaxCheckError) as theirs:
        jax_check_eq(a, b, msg)
    assert str(ours.value) == str(theirs.value)
    assert isinstance(ours.value, AssertionError)


def test_top_level_config_and_version():
    from distlr_tpu_torch.config import Config

    assert distlr_tpu_torch.Config is Config
    assert distlr_tpu_torch.__version__ == distlr_tpu.__version__ == "0.1.0"


def test_new_names_load_no_torch():
    """``import distlr_tpu_torch`` (now with ``Config``), its ``ps``,
    ``data`` and ``utils`` packages and the new names load no ``torch``."""
    probe = ("import sys\n"
             "import distlr_tpu_torch, distlr_tpu_torch.ps\n"
             "from distlr_tpu_torch import Config, __version__\n"
             "from distlr_tpu_torch.data import HashedFeatureEncoder\n"
             "from distlr_tpu_torch.utils import CheckError, check, check_eq\n"
             "Config().to_dict()\n"
             "print(sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'jax')))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", probe], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
