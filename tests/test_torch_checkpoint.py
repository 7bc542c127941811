"""The port's checkpoints (``repro_torch.checkpoint``) and batch loader
(``repro_torch.data.loader``) against ``repro.checkpoint`` and
``repro.data.loader``.

A checkpoint written by either package loads in the other, exactly: same
file layout, same leaf names (``jax.tree_util`` key paths) in the same
order, bf16 stored as f32 and cast back to the template's dtype.  The
loader is numpy code copied into the port, so its batches are bit-identical.
"""
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.data import loader as jloader
from repro_torch import checkpoint as tckpt
from repro_torch.convert import params_from_jax
from repro_torch.data import loader as tloader
from repro_torch.fl import RoundState

torch.set_num_threads(1)


def _reference_tree(seed=0):
    """f32 and bf16 leaves nested two deep, with a list and a tuple."""
    rng = np.random.default_rng(seed)
    return {
        "w": jnp.asarray(rng.normal(size=(3, 4)).astype(np.float32)),
        "opt": {"m": jnp.asarray(rng.normal(size=(3, 4)), jnp.bfloat16),
                "v": jnp.asarray(rng.normal(size=(5,)).astype(np.float32)),
                "count": jnp.asarray(7, jnp.int32)},
        "layers": [{"k": jnp.asarray(rng.normal(size=(2, 2)), jnp.bfloat16)},
                   (jnp.arange(6.0).reshape(2, 3), jnp.zeros((0,)))],
    }


def _as_torch(tree):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, tree),
                           device="cpu")


def _bits(x):
    """A leaf's raw bytes and dtype name (bf16 compared bit for bit)."""
    if isinstance(x, torch.Tensor):
        name = str(x.dtype).replace("torch.", "")
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return name, x.numpy().tobytes(), tuple(x.shape)
    a = np.asarray(x)
    return a.dtype.name, a.tobytes(), a.shape


def _same_tree(got, want):
    g, w = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert _bits(a) == _bits(b)


def test_reference_checkpoint_loads_in_the_port(tmp_path):
    jtree = _reference_tree()
    jckpt.save_checkpoint(str(tmp_path), 5, jtree, meta={"note": "t", "r": 3})
    back, meta = tckpt.load_checkpoint(str(tmp_path), 5,
                                       _as_torch(_reference_tree(1)))
    assert meta == {"note": "t", "r": 3}
    assert back["opt"]["m"].dtype == torch.bfloat16
    assert isinstance(back["layers"], list)
    assert isinstance(back["layers"][1], tuple)
    _same_tree(back, _as_torch(jtree))


def test_port_checkpoint_loads_in_the_reference(tmp_path):
    jtree = _reference_tree()
    path = tckpt.save_checkpoint(str(tmp_path), 12, _as_torch(jtree),
                                 meta={"round": 12})
    assert path == os.path.join(str(tmp_path), "00000012.ckpt.npz")
    back, meta = jckpt.load_checkpoint(str(tmp_path), 12, _reference_tree(2))
    assert meta == {"round": 12}
    assert back["opt"]["m"].dtype == ml_dtypes.bfloat16
    _same_tree(back, jax.tree_util.tree_map(np.asarray, jtree))
    # the header is the reference's, field for field
    ref_dir = tmp_path / "ref"
    jckpt.save_checkpoint(str(ref_dir), 12, jtree, meta={"round": 12})
    with open(tmp_path / "00000012.ckpt.json") as f, \
            open(ref_dir / "00000012.ckpt.json") as g:
        assert json.load(f) == json.load(g)


def test_port_round_trip_and_restore_latest(tmp_path):
    tree = _as_torch(_reference_tree())
    assert tckpt.restore_latest(str(tmp_path / "none"), tree) is None
    for step in (3, 11, 7):
        tckpt.save_checkpoint(str(tmp_path), step,
                              _as_torch(_reference_tree(step)),
                              meta={"step": step})
    step, back, meta = tckpt.restore_latest(str(tmp_path), tree)
    assert step == 11 and meta == {"step": 11}
    _same_tree(back, _as_torch(_reference_tree(11)))
    jstep, jback, _ = jckpt.restore_latest(str(tmp_path), _reference_tree())
    assert jstep == 11
    _same_tree(back, _as_torch(jback))
    # a server state: the NamedTuple's fields name its leaves
    state = RoundState(params={"w": torch.arange(4.0)},
                       round_idx=torch.tensor(3))
    tckpt.save_checkpoint(str(tmp_path / "state"), 1, state)
    with open(tmp_path / "state" / "00000001.ckpt.json") as f:
        assert json.load(f)["names"] == [".params['w']", ".round_idx"]
    back, _ = tckpt.load_checkpoint(str(tmp_path / "state"), 1, state)
    assert isinstance(back, RoundState) and int(back.round_idx) == 3


def test_checkpoint_name_mismatch_raises(tmp_path):
    tckpt.save_checkpoint(str(tmp_path), 1, {"w": torch.ones(2)})
    with pytest.raises(ValueError, match="structure mismatch"):
        tckpt.load_checkpoint(str(tmp_path), 1, {"v": torch.ones(2)})
    jckpt.save_checkpoint(str(tmp_path), 2, {"a": {"b": jnp.ones(2)}})
    with pytest.raises(ValueError, match="structure mismatch"):
        tckpt.load_checkpoint(str(tmp_path), 2, {"a": [torch.ones(2)]})


# ----------------------------------------------------------------- loader

@pytest.mark.parametrize("n,batch,num", [(50, 8, 13), (7, 3, 5), (5, 8, 4)],
                         ids=["epochs", "ragged_tail", "tiny_dataset"])
def test_loader_batches_are_bit_identical(n, batch, num):
    rng = np.random.default_rng(n)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    y = rng.integers(0, 10, size=n)
    got = list(tloader.batch_iterator(x, y, batch, num, seed=3))
    want = list(jloader.batch_iterator(x, y, batch, num, seed=3))
    assert len(got) == len(want) == num
    for (gx, gy), (wx, wy) in zip(got, want):
        assert gx.tobytes() == wx.tobytes() and gy.tobytes() == wy.tobytes()
    e_got = list(tloader.epoch_batches(x, y, batch, np.random.RandomState(1)))
    e_want = list(jloader.epoch_batches(x, y, batch,
                                        np.random.RandomState(1)))
    assert len(e_got) == len(e_want) == n // batch
    for (gx, gy), (wx, wy) in zip(e_got, e_want):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)
