"""Adversarial client models for the edge runtime (``repro.robust.attacks``).

An attack is a frozen, hashable dataclass implementing :class:`AttackModel`:
``corrupt(deltas, grads, noise)`` maps the honest (update, gradient) trees
of a stack of clients (every leaf with a leading K axis) to the adversarial
pair they report instead.

  * ``byzantine_gauss`` — replaces BOTH the update and the gradient report
    with Gaussian noise scaled to ``scale ×`` each client's own honest norm
    (one norm per row of the stack, as the reference's vmap over K gives).
  * ``sign_flip``      — reports ``−factor·Δ, −factor·g``.
  * ``scaled_update``  — model-replacement boost ``factor·Δ`` (gradient
    report left honest).
  * ``label_flip``     — data poisoning: ``corrupts_data`` attacks leave the
    update path alone and flip the malicious shards' training labels before
    the run (:func:`poison_labels`).

Noise.  The reference draws from ``jax.random`` keys split per client and
per leaf, a stream torch cannot reproduce.  Here the draw is a seam: a
:data:`Noise` callable ``noise(deltas, grads) -> (nd, ng)`` returns
standard-normal f32 trees shaped like its arguments, and only the attacks
with ``needs_noise`` call it.  The runtimes pass :func:`generator_noise`
over a ``torch.Generator`` of the adversary's own, seeded per round (sync,
hier) or per arrival (async) through :func:`stream_seed` and never shared
with the mini-batch generator; tests pass the reference's own
``jax.random.normal`` leaves instead.

Adversary placement is a seeded numpy draw on the fleet
(:func:`assign_adversaries` → ``fleet.malicious``), bit-identical to the
reference's, so every runtime sees the same compromised devices.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import (Any, Callable, ClassVar, Protocol, Tuple,
                    runtime_checkable)

import numpy as np
import torch

from ..core.flatten import tree_leaves, tree_map
from ..data.federated import FederatedDataset
from ..edge.profiles import Fleet

Tree = Any
Noise = Callable[[Tree, Tree], Tuple[Tree, Tree]]


@runtime_checkable
class AttackModel(Protocol):
    """What the runtimes require of an adversary."""
    name: str
    corrupts_data: bool
    needs_noise: bool

    def corrupt(self, deltas: Tree, grads: Tree,
                noise: Noise = None) -> Tuple[Tree, Tree]:
        ...


def stream_seed(*parts: int) -> int:
    """A 63-bit ``torch.Generator`` seed from non-negative integers (run
    seed, round or arrival, stream tag) — distinct streams for distinct
    tuples, the port's form of the reference's ``fold_in`` chains."""
    state = np.random.SeedSequence([int(p) for p in parts]).generate_state(
        1, np.uint64)
    return int(state[0]) & ((1 << 63) - 1)


def generator_noise(generator: torch.Generator) -> Noise:
    """A :data:`Noise` drawing every leaf of ``deltas`` then of ``grads``,
    in flattening order, from ``generator`` (on its device), moved to each
    leaf's device."""
    def draw(tree: Tree) -> Tree:
        return tree_map(lambda l: torch.randn(
            l.shape, generator=generator, dtype=torch.float32,
            device=generator.device).to(l.device), tree)

    def noise(deltas: Tree, grads: Tree) -> Tuple[Tree, Tree]:
        nd = draw(deltas)
        return nd, draw(grads)
    return noise


def _row_norms(tree: Tree) -> torch.Tensor:
    """(K,) f32: each row's norm over every leaf of a stacked tree."""
    leaves = tree_leaves(tree)
    K = leaves[0].shape[0]
    sq = sum(l.float().reshape(K, -1).square().sum(dim=1) for l in leaves)
    return torch.sqrt(sq + 1e-30)


def _rows(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return v.view((-1,) + (1,) * (like.dim() - 1))


def _noise_like(tree: Tree, noise: Tree, target_norm: torch.Tensor) -> Tree:
    """``noise`` rescaled row by row to the (K,) ``target_norm``, in the
    dtypes of ``tree`` (direction uniform on the sphere)."""
    ratio = target_norm / _row_norms(noise)
    return tree_map(lambda n, l: (n * _rows(ratio, n)).to(l.dtype),
                    noise, tree)


@dataclass(frozen=True)
class ByzantineGauss:
    """Noise replacement at ``scale ×`` the honest norms, on update AND
    gradient report."""
    scale: float = 10.0
    name: ClassVar[str] = "byzantine_gauss"
    corrupts_data: ClassVar[bool] = False
    needs_noise: ClassVar[bool] = True

    def corrupt(self, deltas, grads, noise=None):
        if noise is None:
            raise ValueError("byzantine_gauss needs a noise source "
                             "(generator_noise or replayed draws)")
        nd, ng = noise(deltas, grads)
        return (_noise_like(deltas, nd, self.scale * _row_norms(deltas)),
                _noise_like(grads, ng, self.scale * _row_norms(grads)))


@dataclass(frozen=True)
class SignFlip:
    """Reports the negated (optionally boosted) update and gradient."""
    factor: float = 1.0
    name: ClassVar[str] = "sign_flip"
    corrupts_data: ClassVar[bool] = False
    needs_noise: ClassVar[bool] = False

    def corrupt(self, deltas, grads, noise=None):
        neg = lambda l: (-self.factor * l.float()).to(l.dtype)  # noqa: E731
        return tree_map(neg, deltas), tree_map(neg, grads)


@dataclass(frozen=True)
class ScaledUpdate:
    """Model-replacement boost: ``factor × Δ``, honest gradient report."""
    factor: float = 10.0
    name: ClassVar[str] = "scaled_update"
    corrupts_data: ClassVar[bool] = False
    needs_noise: ClassVar[bool] = False

    def corrupt(self, deltas, grads, noise=None):
        boost = lambda l: (self.factor * l.float()).to(l.dtype)  # noqa: E731
        return tree_map(boost, deltas), grads


@dataclass(frozen=True)
class LabelFlip:
    """Data poisoning: training labels of malicious shards are flipped to
    ``(num_classes − 1) − y`` before the run (:func:`poison_labels`); the
    update path itself is honest."""
    name: ClassVar[str] = "label_flip"
    corrupts_data: ClassVar[bool] = True
    needs_noise: ClassVar[bool] = False

    def corrupt(self, deltas, grads, noise=None):
        return deltas, grads


_ATTACKS = {"byzantine_gauss": ByzantineGauss, "sign_flip": SignFlip,
            "scaled_update": ScaledUpdate, "label_flip": LabelFlip}


def get_attack(name: str, **kw) -> AttackModel:
    if name not in _ATTACKS:
        raise KeyError(f"unknown attack '{name}'; have {sorted(_ATTACKS)}")
    return _ATTACKS[name](**kw)


def available_attacks() -> Tuple[str, ...]:
    return tuple(sorted(_ATTACKS))


# ---------------------------------------------------------------------------
# adversary placement + corruption helpers shared by the three runtimes
# ---------------------------------------------------------------------------

def assign_adversaries(fleet: Fleet, frac: float, seed: int = 0) -> Fleet:
    """Seeded draw of ``round(frac · N)`` compromised devices onto the fleet
    (``fleet.malicious``), bit-identical to the reference's."""
    if not (0.0 <= frac < 1.0):
        raise ValueError(f"malicious fraction must be in [0, 1), got {frac}")
    m = int(round(frac * fleet.num_devices))
    if m == 0:
        return dataclasses.replace(fleet, malicious=())
    rng = np.random.RandomState(seed)
    ids = rng.choice(fleet.num_devices, m, replace=False)
    return dataclasses.replace(fleet,
                               malicious=tuple(sorted(int(i) for i in ids)))


def poison_labels(dataset: FederatedDataset, malicious) -> FederatedDataset:
    """Label-flip poisoning of the malicious device shards: ``y ← (C−1) − y``
    on train labels only (the test set stays clean)."""
    mal = np.asarray(sorted(set(int(i) for i in malicious)), np.int64)
    if mal.size == 0:
        return dataset
    y = np.array(dataset.y)
    y[mal] = (dataset.num_classes - 1) - y[mal]
    return FederatedDataset(x=dataset.x, y=y, mask=dataset.mask,
                            test_x=dataset.test_x, test_y=dataset.test_y,
                            num_classes=dataset.num_classes)


def corrupt_stacked(attack: AttackModel, deltas: Tree, grads: Tree,
                    mask: torch.Tensor, noise: Noise = None
                    ) -> Tuple[Tree, Tree]:
    """Apply ``attack`` to the rows of stacked (K-leading) update / gradient
    trees where the (K,) bool ``mask`` holds; the other rows are the inputs
    themselves, bit for bit (``torch.where``)."""
    cd, cg = attack.corrupt(deltas, grads, noise)

    def mix(c, o):
        return torch.where(_rows(mask, o), c, o)

    return tree_map(mix, cd, deltas), tree_map(mix, cg, grads)


def corrupt_one(attack: AttackModel, delta: Tree, grad: Tree,
                noise: Noise = None) -> Tuple[Tree, Tree]:
    """Corruption of one client's trees (no K axis): the async runtime's
    per-arrival path."""
    cd, cg = attack.corrupt(tree_map(lambda l: l[None], delta),
                            tree_map(lambda l: l[None], grad), noise)
    return tree_map(lambda l: l[0], cd), tree_map(lambda l: l[0], cg)
