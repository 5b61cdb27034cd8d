"""The port's checkpoints against the JAX package's, on the CPU.

The port's msgpack codec writes ``msgpack.packb``'s bytes and reads them
back; a checkpoint written by either package loads bit-exactly in the
other (float32 and bf16 leaves, stacked layers, an encoder, the optimizer
state), and the port writes the very bytes the JAX package writes for the
same parameters; the port saves and loads with neither ``msgpack`` nor
``ml_dtypes`` importable.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.train import checkpoint as jax_checkpoint
from repro.train.optimizer import init_opt_state as jax_init_opt_state
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.models import Model
from repro_torch.train import _msgpack
from repro_torch.train.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.train.optimizer import init_opt_state
from test_torch_model import MODEL_CONFIGS, _build

REPO = Path(__file__).resolve().parents[1]

# every length and value boundary of the encodings the codec picks
VALUES = (
    [None, True, False]
    + [n for k in (7, 8, 16, 32) for n in (2 ** k - 1, 2 ** k)] + [2 ** 64 - 1]
    + [-n for k in (5, 7, 15, 31) for n in (2 ** k, 2 ** k + 1)] + [-2 ** 63]
    + ["", "é" * 3] + ["x" * n for n in (31, 32, 255, 256, 65535, 65536)]
    + [b"\x00" * n for n in (0, 255, 256, 65535, 65536)]
    + [list(range(n)) for n in (0, 15, 16, 65536)] + [(1, "two", [None])]
    + [{f"k{i}": i for i in range(n)} for n in (0, 15, 16, 65536)]
    + [{"treedef": "PyTreeDef({'w': *})", "leaves": [{"dtype": "bfloat16", "shape": [2, 3],
                                                      "data": bytes(range(12))}]}]
)

# name -> (config key of tests/test_torch_model.py, dtype)
CASES = {"whisper-f32": ("whisper-base-smoke", "float32"),
         "whisper-bf16": ("whisper-base-smoke", "bfloat16"),
         "jamba-bf16": ("jamba-v0.1-52b-smoke", "bfloat16"),
         "olmo-f32": ("olmo-1b-smoke", "float32")}


@pytest.mark.parametrize("value", VALUES, ids=range(len(VALUES)))
def test_codec_writes_and_reads_what_msgpack_does(value):
    msgpack = pytest.importorskip("msgpack")
    packed = _msgpack.packb(value)
    assert packed == msgpack.packb(value)
    want = msgpack.unpackb(packed)
    assert _msgpack.unpackb(packed) == want
    assert _msgpack.unpackb(bytearray(packed)) == want


def test_codec_refuses_what_it_cannot_read():
    with pytest.raises(ValueError, match="extra bytes"):
        _msgpack.unpackb(_msgpack.packb(1) + b"\x00")
    with pytest.raises(ValueError, match="truncated"):
        _msgpack.unpackb(_msgpack.packb(b"abc")[:-1])
    with pytest.raises(TypeError):
        _msgpack.packb(0.5)


def _case(name):
    key, dtype = CASES[name]
    return _build(tuple(dataclasses.replace(c, dtype=dtype) for c in MODEL_CONFIGS[key]()))


def _bits(t: torch.Tensor) -> bytes:
    return t.detach().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


@pytest.mark.parametrize("name", sorted(CASES))
def test_jax_checkpoint_loads_into_the_port(name, tmp_path):
    jm, params, model = _case(name)
    opt = jax_init_opt_state(params)
    opt = opt._replace(m=jax.tree_util.tree_map(lambda x: x + 0.25, opt.m), step=opt.step + 9)
    path = jax_checkpoint.save_checkpoint(tmp_path, 9, params, opt)
    other = Model(model.cfg, device="cpu")
    other.init_params(7)
    step, other, got = load_checkpoint(path, other, init_opt_state(other))
    assert step == 9 and int(got.step) == 9
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, params), model.cfg)
    for n, p in other.named_parameters():
        assert p.dtype == want[n].dtype and _bits(p) == _bits(want[n]), n
    assert all(bool((t == 0.25).all()) for t in got.m.values())
    assert all(bool((t == 0).all()) for t in got.v.values())


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_checkpoint_is_the_jax_packages(name, tmp_path):
    """The port's file equals the JAX package's for the same parameters
    and state, byte for byte, and the JAX loader reads it back bit-exactly."""
    jm, params, model = _case(name)
    port = save_checkpoint(tmp_path / "port", 3, model, init_opt_state(model))
    ref = jax_checkpoint.save_checkpoint(tmp_path / "jax", 3, params, jax_init_opt_state(params))
    assert port.name == ref.name
    assert port.read_bytes() == ref.read_bytes()
    step, loaded, _ = jax_checkpoint.load_checkpoint(port, params, jax_init_opt_state(params))
    assert step == 3
    mine = params_to_jax(model)
    pairs = zip(jax.tree_util.tree_leaves(loaded), jax.tree_util.tree_leaves(mine), strict=True)
    for a, b in pairs:
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("name", sorted(CASES))
def test_params_to_jax_inverts_params_from_jax(name):
    jm, params, model = _case(name)
    back = params_from_jax(params_to_jax(model), model.cfg)
    for n, p in model.named_parameters():
        assert p.dtype == back[n].dtype and _bits(p) == _bits(back[n]), n
    want = jax.tree_util.tree_structure(params)
    assert jax.tree_util.tree_structure(params_to_jax(model)) == want


SCRIPT = """
import sys
sys.modules["msgpack"] = sys.modules["ml_dtypes"] = None
import dataclasses
import tempfile
import torch
from repro_torch.configs import get_smoke_config
from repro_torch.models import Model
from repro_torch.train.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.train.optimizer import init_opt_state

cfg = dataclasses.replace(get_smoke_config("jamba-v0.1-52b"), dtype="bfloat16")
model, other = Model(cfg, device="cpu"), Model(cfg, device="cpu")
model.init_params(0)
other.init_params(1)
opt = init_opt_state(model)
opt.m["embed.w"].fill_(0.5)
with tempfile.TemporaryDirectory() as tmp:
    path = save_checkpoint(tmp, 5, model, opt)
    step, other, got = load_checkpoint(path, other, init_opt_state(other))
assert step == 5
for (n, a), (_, b) in zip(model.named_parameters(), other.named_parameters()):
    assert torch.equal(a, b), n
assert torch.equal(got.m["embed.w"], opt.m["embed.w"])
assert model.embed["w"].dtype == torch.bfloat16
for name in ("msgpack", "ml_dtypes", "jax", "repro"):
    assert sys.modules.get(name) is None, name
print("ok")
"""


def test_port_checkpoints_need_neither_msgpack_nor_ml_dtypes():
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    run = subprocess.run([sys.executable, "-c", SCRIPT], env=env, capture_output=True,
                         text=True, timeout=300, cwd=REPO)
    assert run.returncode == 0 and run.stdout.strip() == "ok", run.stderr
