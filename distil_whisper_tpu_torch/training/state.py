"""Train state: masked AdamW with mixed-precision policies, frozen prefixes
and gradient accumulation, in plain PyTorch.

The port of ``distil_whisper_tpu.training.state``, whose update is an optax
chain.  This module computes that update itself, in optax's order:

1. ``MultiSteps`` (``gradient_accumulation_steps`` k > 1): the running mean
   of k micro-step gradients (``acc + (g - acc) / (n + 1)``); the steps
   below run only on the k-th micro-step, the others leave the parameters
   as they are.  The schedule and Adam's count advance on real updates
   only; ``TrainState.step`` counts micro-steps.
2. ``clip_by_global_norm`` over every gradient, frozen ones included (under
   ``freeze_decoder`` they are not zero).
3. AdamW on the trainable leaves: ``mu = b1 mu + (1 - b1) g``, ``nu = b2 nu
   + (1 - b2) g^2``, bias correction at count + 1, ``u = mu_hat /
   (sqrt(nu_hat) + eps)``, plus ``weight_decay * p`` where the decay mask
   holds, times ``-lr(count)``, the schedule read at the count before the
   increment (under linear warmup from 0 the first update has lr 0).
4. Frozen leaves (paths under ``frozen_prefixes``) get no moments (a frozen
   large-v3 encoder allocates no fp32 moments) and a zero update.

Precision policies: ``full`` fp32 params and compute; ``half_mixed`` fp32
master params and bf16 compute, frozen leaves stored in the compute dtype;
``full_mixed`` bf16 params, fp32 moments, each update upcast, applied and
cast back.  The update runs leaf by leaf in place, under ``no_grad``.

A gradient of ``None`` (a leaf the loss does not reach, such as the
detached encoder positions or a frozen encoder) counts as zeros, as JAX's
zero gradient: weight decay still moves such a leaf when it is trainable.

Tensor parallelism (a mesh with a 'model' axis, :func:`place_state`): the
parameters, moments and accumulated gradient hold this rank's shards
(``parallel.mesh.shard_params``); the global norm sums the sharded leaves'
squares over the model group and counts the replicated ones once, so that
clipping is the unsharded step's; :meth:`TrainState.state_dict` gathers
the shards (a collective) and :meth:`TrainState.load_state_dict` slices an
unsharded state onto this rank, so checkpoints are topology-free.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..models.params import map_with_path, tree_paths, unflatten_paths
from ..parallel import tensor_parallel as tp
from ..parallel.mesh import (gather_leaf, model_dim, model_group,
                             replicate_over_data, shard_leaf)

Params = Any


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    learning_rate: float = 1e-4
    warmup_steps: int = 500
    total_steps: int = 100_000
    schedule: str = "linear"        # constant_with_warmup | linear
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    max_grad_norm: Optional[float] = 1.0
    gradient_accumulation_steps: int = 1
    precision: str = "half_mixed"   # full | half_mixed | full_mixed
    frozen_prefixes: Tuple[str, ...] = ()  # e.g. ("encoder",) to freeze it

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.float32 if self.precision == "full" else torch.bfloat16

    @property
    def param_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.precision == "full_mixed" else torch.float32


def decays(path: str) -> bool:
    """True where weight decay applies: kernels and embeddings, not
    LayerNorms or biases."""
    return not (path.endswith(".bias") or ".ln" in path
                or path.endswith(".scale") or "_ln." in path)


def trainable(path: str, frozen_prefixes) -> bool:
    return not any(path.startswith(f) for f in frozen_prefixes)


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax.linear_schedule: ``init`` to ``end`` over ``steps`` counts, a
    constant ``init`` when ``steps`` is not positive."""
    def f(count: int) -> float:
        if steps <= 0:
            return init
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end
    return f


def make_schedule(cfg: OptimizerConfig) -> Callable[[int], float]:
    """The learning rate at an update count (optax.join_schedules of a
    linear warmup from 0 and a constant or linear decay to 0)."""
    warmup = _linear(0.0, cfg.learning_rate, cfg.warmup_steps)
    if cfg.schedule == "constant_with_warmup":
        def rest(count):
            return cfg.learning_rate
    else:
        rest = _linear(cfg.learning_rate, 0.0,
                       max(cfg.total_steps - cfg.warmup_steps, 1))
    return lambda count: (warmup(count) if count < cfg.warmup_steps
                          else rest(count - cfg.warmup_steps))


def global_norm(grads: Dict[str, Optional[torch.Tensor]],
                group=None) -> torch.Tensor:
    """fp32 sqrt of the sum of squares of every gradient (None = zeros),
    the gradients keyed by parameter path.  ``group``: the model group of
    a tensor-parallel state, over which the sharded leaves' squares are
    summed (every rank holds the replicated leaves whole)."""
    device = next((g.device for g in grads.values() if g is not None), "cpu")

    def total(keep):
        sq = [g.float().square().sum() for p, g in grads.items()
              if g is not None and keep(p)]
        return torch.stack(sq).sum() if sq else torch.zeros((), device=device)
    if group is None:
        return total(lambda p: True).sqrt()
    sharded = tp.reduce_sum(total(lambda p: model_dim(p) is not None), group)
    return (total(lambda p: model_dim(p) is None) + sharded).sqrt()


@dataclasses.dataclass
class TrainState:
    """Parameters (stored by the precision policy, ``requires_grad`` set on
    every floating leaf), AdamW moments of the trainable leaves (fp32),
    the count of real updates, the running-mean gradient of gradient
    accumulation and the micro-step count ``step``.  ``apply_gradients``
    updates all of it in place and returns the state."""
    step: int
    params: Params
    cfg: OptimizerConfig
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    count: int = 0
    acc: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    mini_step: int = 0
    # the mesh whose 'model' axis the tensors are sharded over (place_state)
    mesh: Any = None

    @property
    def model_group(self):
        return model_group(self.mesh)

    @classmethod
    def create(cls, params: Params, cfg: OptimizerConfig) -> "TrainState":
        """A state that owns fresh copies of ``params`` cast by policy:
        trainable leaves in ``param_dtype``, frozen ones in the compute
        dtype (a frozen encoder carries no fp32 master copy)."""
        flat = {}
        mu = {}
        for path, x in tree_paths(params).items():
            train = trainable(path, cfg.frozen_prefixes)
            if x.is_floating_point():
                dtype = cfg.param_dtype if train else cfg.compute_dtype
                x = x.detach().to(dtype, copy=True).requires_grad_(True)
                if train:
                    mu[path] = torch.zeros_like(x, dtype=torch.float32)
            else:
                x = x.clone()
            flat[path] = x
        nu = {p: torch.zeros_like(m) for p, m in mu.items()}
        return cls(step=0, params=unflatten_paths(flat), cfg=cfg, mu=mu, nu=nu)

    def leaves(self) -> Dict[str, torch.Tensor]:
        """The parameters that take gradients, by path."""
        return {p: x for p, x in tree_paths(self.params).items()
                if x.is_floating_point()}

    @torch.no_grad()
    def apply_gradients(self, grads: Dict[str, Optional[torch.Tensor]]
                        ) -> "TrainState":
        """One micro-step: ``grads`` maps the paths of :meth:`leaves` to
        gradients (None = zeros)."""
        cfg = self.cfg
        k = cfg.gradient_accumulation_steps
        g32 = {p: (g.float() if g is not None else None)
               for p, g in grads.items()}
        self.step += 1
        if k > 1:
            n = self.mini_step
            for p, g in g32.items():
                acc = self.acc.get(p)
                if g is None and acc is None:
                    continue
                if acc is None:
                    acc = torch.zeros_like(g)
                self.acc[p] = acc + ((g if g is not None else 0.0) - acc) / (n + 1)
            self.mini_step = (n + 1) % k
            if self.mini_step:
                return self
            g32, self.acc = self.acc, {}
        self._update(g32)
        return self

    def _update(self, g32: Dict[str, Optional[torch.Tensor]]) -> None:
        cfg = self.cfg
        if cfg.max_grad_norm is not None:
            norm = global_norm(g32, self.model_group)
            keep = norm < cfg.max_grad_norm
            g32 = {p: (torch.where(keep, g, g / norm * cfg.max_grad_norm)
                       if g is not None else None) for p, g in g32.items()}
        lr = make_schedule(cfg)(self.count)
        self.count += 1
        bc1 = 1.0 - cfg.b1 ** self.count
        bc2 = 1.0 - cfg.b2 ** self.count
        for path, x in self.leaves().items():
            if path not in self.mu:
                continue                        # frozen: zero update
            g = g32.get(path)
            mu, nu = self.mu[path], self.nu[path]
            if g is None:
                mu.mul_(cfg.b1)
                nu.mul_(cfg.b2)
            else:
                mu.mul_(cfg.b1).add_((1.0 - cfg.b1) * g)
                nu.mul_(cfg.b2).add_((1.0 - cfg.b2) * g.square())
            u = (mu / bc1) / ((nu / bc2).sqrt() + cfg.eps)
            x32 = x.float()
            if decays(path):
                u = u + cfg.weight_decay * x32
            x.copy_(x32 + (-lr) * u)

    # -- checkpoint contents -------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        """The unsharded state: under tensor parallelism every rank of a
        model group must call it (the shards are gathered)."""
        def full(d):
            return {p: gather_leaf(p, x.detach(), self.mesh)
                    for p, x in d.items()}
        return {"step": self.step, "count": self.count,
                "mini_step": self.mini_step,
                "params": full(tree_paths(self.params)),
                "mu": full(self.mu), "nu": full(self.nu),
                "acc": full(self.acc)}

    @torch.no_grad()
    def load_state_dict(self, sd: Dict[str, Any]) -> "TrainState":
        """Restore in place: every tensor keeps this state's dtype and
        device, so a resumed run continues bit for bit."""
        self.step, self.count = int(sd["step"]), int(sd["count"])
        self.mini_step = int(sd["mini_step"])
        for path, x in tree_paths(self.params).items():
            x.copy_(shard_leaf(path, sd["params"][path], self.mesh))
        for name in ("mu", "nu"):
            mine = getattr(self, name)
            if sorted(mine) != sorted(sd[name]):
                raise ValueError(f"checkpoint {name} covers other leaves "
                                 "(another frozen set?)")
            for p, m in mine.items():
                m.copy_(shard_leaf(p, sd[name][p], self.mesh))
        device = next(iter(self.leaves().values())).device
        self.acc = {p: shard_leaf(p, a, self.mesh).to(device)
                    for p, a in sd["acc"].items()}
        return self


def place_state(state: TrainState, mesh=None) -> TrainState:
    """JAX ``place_state``'s counterpart: on a mesh with a 'model' axis the
    params, AdamW moments and accumulated gradient of an unsharded state
    are sliced to this rank's shards (once: the state keeps its mesh), and
    under data parallelism all of them are overwritten in place with the
    first data rank's values (after a resume too, so every replica
    continues from bit-identical state).  No-op in a single process."""
    if model_group(mesh) is not None and state.mesh is None:
        state.params = map_with_path(
            lambda p, x: shard_leaf(p, x, mesh), state.params)
        for name in ("mu", "nu", "acc"):
            setattr(state, name, {p: shard_leaf(p, x, mesh)
                                  for p, x in getattr(state, name).items()})
        state.mesh = mesh
    replicate_over_data({"params": state.params, "mu": state.mu,
                         "nu": state.nu, "acc": state.acc}, mesh)
    return state
