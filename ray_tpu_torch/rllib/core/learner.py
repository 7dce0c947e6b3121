"""TorchLearner: the training half of the RL stack (counterpart of the JAX
package's ``rllib/core/learner.py`` ``JaxLearner``).

Parity: reference rllib/core/learner/learner.py + torch_learner.py. One
update is loss, backward, the reference's optimizer chain and the step,
on the learner's device (the card unless the caller asks for the CPU).
Algorithms subclass and implement ``loss(params, batch, generator)``.

- The optimizer is ``optax.chain(clip_by_global_norm(grad_clip),
  adam(lr))``: the clip in optax's form (scale by ``max_norm / norm`` only
  where ``norm > max_norm``; ``torch.nn.utils.clip_grad_norm_`` divides
  by ``norm + 1e-6`` instead), then ``torch.optim.Adam``, whose update is
  optax's: bias-corrected moments, eps outside the square root
  (``mu_hat / (sqrt(nu_hat) + eps)``), b1 0.9, b2 0.999, eps 1e-8.
- ``grad_norm`` is the global norm before the clip, as the reference's.
- The loss and its backward run with cuDNN's TF32 off
  (``catalog.f32_convs``): the convolutions' gradients are f32, as the
  reference's.
- Params and state come and go as numpy trees in the reference's names
  and layouts (``get_weights``/``get_state``: the optimizer state as
  optax's Adam names it, ``count``, ``mu``, ``nu``), so JAX weights load
  into the port and back.
- ``mesh``: with ``data`` or ``fsdp`` > 1, each rank takes its rows of
  every minibatch and the gradients are summed over those axes. The
  losses divide their masked sums by the global mask sum
  (:meth:`mask_sum`), as the reference's global mean does, so the summed
  gradient is the global batch's; the losses and metrics, all such
  quotients, are summed the same way, except ``replicated_metrics``
  (values every rank holds whole, such as SAC's alpha). Per-row metrics
  come back whole from :meth:`take_td_errors`.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ...device import DeviceLike, resolve_device
from ...parallel.mesh import mesh_device, mesh_shape
from ...parallel.sharding import axis_coord
from . import catalog
from .rl_module import RLModule

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def tree_map(fn: Callable, tree: Any) -> Any:
    """``fn`` on every leaf of a tree of dicts, lists and tuples. Dict keys
    are visited in sorted order, as JAX's tree functions visit them."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves in :func:`tree_map`'s order (``jax.tree.leaves``')."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def mean_metrics(steps: List[Dict[str, torch.Tensor]]) -> Dict[str, float]:
    """The mean of each metric over the steps, as floats: one host sync."""
    if not steps:
        return {}
    keys = list(steps[0])
    table = torch.stack([torch.stack([m[k].detach().float() for k in keys])
                         for m in steps])
    return dict(zip(keys, table.double().mean(0).tolist()))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy (never a view of a CPU tensor that later updates
    change in place)."""
    return t.detach().to("cpu", copy=True).numpy()


class TorchLearner:
    # Metrics the loss returns per row (DQN's and SAC's |TD error|, the
    # prioritized buffer's signal): taken out of the metrics before their
    # reduction to one value each, and kept on the device in
    # ``self.last_rows`` until the algorithm asks for them.
    per_row_metrics: Tuple[str, ...] = ()
    # Metrics every rank of a mesh computes whole (not a quotient of a
    # masked sum): reported as they are, not summed over the ranks.
    replicated_metrics: Tuple[str, ...] = ()

    def __init__(
        self,
        module: RLModule,
        *,
        lr: float = 3e-4,
        grad_clip: Optional[float] = 0.5,
        mesh=None,
        seed: int = 0,
        device: DeviceLike = None,
    ):
        self.module = module
        self.mesh = mesh
        self.grad_clip = grad_clip
        if mesh is not None:
            self.device = mesh_device(mesh)
            shape = mesh_shape(mesh)
            self._batch_axes = tuple(a for a in ("data", "fsdp")
                                     if shape[a] > 1)
            self._n_shards = math.prod(shape[a] for a in self._batch_axes)
        else:
            self.device = resolve_device(device)
            self._batch_axes, self._n_shards = (), 1
        # Drawn on the host, so every device starts from the same params.
        init = module.init(torch.Generator().manual_seed(seed))
        self.params = tree_map(
            lambda t: t.to(self.device).requires_grad_(True), init)
        self._leaves = tree_leaves(self.params)
        self.optimizer = torch.optim.Adam(
            self._leaves, lr=lr, betas=(ADAM_B1, ADAM_B2), eps=ADAM_EPS)
        self._rng = np.random.default_rng(seed)
        self._generator = torch.Generator(self.device).manual_seed(seed)
        self.last_rows: Dict[str, torch.Tensor] = {}

    # ------------------------------------------------------------------ loss

    def loss(self, params, batch: Dict[str, torch.Tensor],
             generator: torch.Generator
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Return (scalar loss, metrics). Implemented by the algorithm."""
        raise NotImplementedError

    def global_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` (a tensor that needs no gradient) over the
        whole minibatch: every rank's rows on a mesh."""
        total = x.sum()
        for axis in self._batch_axes:
            dist.all_reduce(total, group=self.mesh.get_group(axis))
        return total

    def mask_sum(self, mask: torch.Tensor) -> torch.Tensor:
        """The mask's sum over the whole minibatch, at least 1: what the
        losses' masked means divide by. ``mask_sum(torch.ones_like(x))``
        is the minibatch's row count, for a plain mean."""
        return self.global_sum(mask).clamp_min(1.0)

    # ---------------------------------------------------------------- update

    def _step(self, batch: Dict[str, torch.Tensor], **loss_kw
              ) -> Dict[str, torch.Tensor]:
        """One update; ``loss_kw`` go to the loss (SAC's given noise)."""
        self.optimizer.zero_grad(set_to_none=True)
        # TF32 off for the convolutions' gradients too (the forward's
        # flags do not reach the backward).
        with catalog.f32_convs():
            loss, metrics = self.loss(self.params, batch, self._generator,
                                      **loss_kw)
            loss.backward()
        metrics = dict(metrics)
        self.last_rows = {k: metrics.pop(k).detach()
                          for k in self.per_row_metrics}
        metrics["total_loss"] = loss
        for p in self._leaves:
            if p.grad is None:  # a leaf the loss does not reach
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self._leaves]
        summed = [k for k in metrics if k not in self.replicated_metrics]
        values = [metrics[k].detach().reshape(1) for k in summed]
        if self._batch_axes:
            # One buffer a minibatch: the gradients and the metrics.
            flat = torch.cat([g.reshape(-1) for g in grads] + values)
            for axis in self._batch_axes:
                dist.all_reduce(flat, group=self.mesh.get_group(axis))
            parts = flat.split([g.numel() for g in grads] + [1] * len(values))
            for p, g in zip(self._leaves, parts):
                p.grad = g.view_as(p)
            grads = [p.grad for p in self._leaves]
            values = parts[len(grads):]
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g) for g in grads]))
        if self.grad_clip is not None:
            scale = torch.where(norm < self.grad_clip, torch.ones_like(norm),
                                self.grad_clip / norm)
            torch._foreach_mul_(grads, scale)
        self.optimizer.step()
        out = {k: metrics[k].detach() for k in self.replicated_metrics}
        out.update(zip(summed, (v[0] for v in values)))
        out["grad_norm"] = norm
        return out

    def _to_device(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        return {k: (v if isinstance(v, torch.Tensor)
                    else torch.as_tensor(np.asarray(v))).to(self.device)
                for k, v in batch.items()}

    def _local_rows(self, rows: np.ndarray) -> np.ndarray:
        """This rank's rows of a minibatch: its slice along the batch axes,
        as the reference's batch sharding splits them."""
        if not self._batch_axes:
            return rows
        if len(rows) % self._n_shards:
            raise ValueError(f"minibatch of {len(rows)} rows does not split "
                             f"over {self._n_shards} batch shards")
        per = len(rows) // self._n_shards
        c = axis_coord(self.mesh, self._batch_axes)
        return rows[c * per:(c + 1) * per]

    def _local_batch(self, batch: Dict[str, Any], n: int
                     ) -> Dict[str, Any]:
        """This rank's rows of every column of an ``n``-row minibatch: a
        column of ``k * n`` rows (CQL's proposals, ``k`` a row) gives the
        ``k``-row blocks of those rows."""
        if not self._batch_axes:
            return batch
        rows = self._local_rows(np.arange(n))
        lo, hi = int(rows[0]), int(rows[-1]) + 1
        return {key: v[lo * (len(v) // n):hi * (len(v) // n)]
                for key, v in batch.items()}

    def take_td_errors(self) -> np.ndarray:
        """|TD errors| of the last update's minibatch, every rank's rows in
        the minibatch's order (the prioritized buffer's signal); empty
        before the first update. One host copy."""
        td = self.last_rows.get("td_abs")
        if td is None:
            return np.zeros(0, np.float32)
        if self._batch_axes:
            # Each rank's rows in their place, zeros elsewhere, summed.
            n = td.numel()
            c = axis_coord(self.mesh, self._batch_axes)
            whole = td.new_zeros(n * self._n_shards)
            whole[c * n:(c + 1) * n] = td
            for axis in self._batch_axes:
                dist.all_reduce(whole, group=self.mesh.get_group(axis))
            td = whole
        return td.cpu().numpy()

    def update(
        self,
        batch: Dict[str, np.ndarray],
        *,
        minibatch_size: Optional[int] = None,
        num_epochs: int = 1,
        shuffle: bool = True,
    ) -> Dict[str, float]:
        """Minibatch SGD over the batch; returns the averaged metrics."""
        n = next(iter(batch.values())).shape[0]
        # Clamp: a requested minibatch larger than the batch must still run
        # ONE full-batch step. Tail rows that don't fill a minibatch are
        # dropped, as in the reference's minibatch iterator.
        mb = min(minibatch_size or n, n)
        rng_np = np.random.default_rng(int(self._rng.integers(2**31 - 1)))
        # The whole batch goes to the device once (pixels as uint8); the
        # minibatches are gathered there.
        on_device = self._to_device(batch)
        all_metrics: list = []
        for _ in range(num_epochs):
            idx = rng_np.permutation(n) if shuffle else np.arange(n)
            for start in range(0, n - mb + 1, mb):
                rows = torch.as_tensor(self._local_rows(idx[start:start + mb]),
                                       device=self.device)
                sub = {k: v.index_select(0, rows)
                       for k, v in on_device.items()}
                all_metrics.append(self._step(sub))
        return mean_metrics(all_metrics)

    # ----------------------------------------------------------- state/ckpt

    def get_weights(self) -> Any:
        return tree_map(to_numpy, self.params)

    def set_weights(self, weights: Any) -> None:
        """Copy a tree in the params' names and layouts (numpy arrays or
        tensors) into the params, in place: the optimizer keeps them."""
        with torch.no_grad():
            for p, w in zip(self._leaves, tree_leaves(weights)):
                p.copy_(torch.as_tensor(np.array(w)))

    def get_state(self) -> Dict[str, Any]:
        count, mu, nu = 0, [], []
        for p in self._leaves:
            st = self.optimizer.state.get(p)
            if st:
                count = int(st["step"])
                mu.append(to_numpy(st["exp_avg"]))
                nu.append(to_numpy(st["exp_avg_sq"]))
            else:
                mu.append(np.zeros(p.shape, np.float32))
                nu.append(np.zeros(p.shape, np.float32))
        return {
            "params": self.get_weights(),
            "opt_state": {"count": count,
                          "mu": self._like_params(mu),
                          "nu": self._like_params(nu)},
        }

    def set_state(self, state: Dict[str, Any]) -> None:
        self.set_weights(state["params"])
        opt = state["opt_state"]
        for p, m, v in zip(self._leaves, tree_leaves(opt["mu"]),
                           tree_leaves(opt["nu"])):
            # Copies: Adam updates its moments in place, and the caller's
            # arrays must not change with them.
            self.optimizer.state[p] = {
                "step": torch.tensor(float(opt["count"])),
                "exp_avg": torch.tensor(np.asarray(m), device=self.device),
                "exp_avg_sq": torch.tensor(np.asarray(v), device=self.device),
            }

    def _like_params(self, leaves: List[Any]) -> Any:
        it = iter(leaves)
        return tree_map(lambda _: next(it), self.params)
