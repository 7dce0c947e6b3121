"""SAC (Soft Actor-Critic) on the port's learner stack (counterpart of the
JAX package's ``rllib/algorithms/sac.py``): the continuous-control
algorithm of the suite.

Parity: reference rllib/algorithms/sac/ (sac.py training_step: rollout ->
replay buffer -> off-policy updates; squashed-Gaussian policy, twin Q
networks, polyak-averaged targets, learnable entropy temperature against a
target entropy of -|A|).

One update carries all three losses (critic, actor, temperature) over ONE
combined params tree (``actor``, ``log_alpha``, ``q1``, ``q2``, in that
tree order) with a single Adam and one global-norm clip, as the reference:
the actor term sees the critics' params detached (dQ/da stays, dQ/dtheta_Q
goes), and alpha is detached in the critic target and the actor term. The
targets are real copies, moved by ``(1 - tau) * t + tau * s`` after each
update. The noise of the reparameterised samples comes from the learner's
generator, drawn for the whole minibatch before the update
(:meth:`SACLearner.draw_noise`); tests pass it explicitly (``noise=``) to
follow the reference's draws.
"""
from __future__ import annotations

import functools
import math
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..algorithm import Algorithm, LearnerFactory, env_spaces
from ..algorithm_config import AlgorithmConfig
from ..core.learner import TorchLearner, mean_metrics, tree_leaves, tree_map
from ..core.rl_module import RLModule, _dense, _dense_init
from ..utils.replay_buffers import PrioritizedReplayBuffer, make_buffer

_LOG_STD_MIN, _LOG_STD_MAX = -20.0, 2.0


class SACConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or SAC)
        self.replay_buffer_capacity: int = 100_000
        self.replay_buffer_config: dict = {"type": "uniform"}
        self.learning_starts: int = 500
        self.num_updates_per_iter: int = 32
        self.gamma: float = 0.99
        self.tau: float = 0.005           # polyak target coefficient
        self.initial_alpha: float = 1.0
        # None -> -|A| (reference heuristic).
        self.target_entropy: Optional[float] = None


def _mlp(generator, sizes, out_dim, out_scale=1.0):
    n = len(sizes) - 1
    layers = [_dense_init(generator, sizes[i], sizes[i + 1])
              for i in range(n)]
    layers.append(_dense_init(generator, sizes[-1], out_dim, scale=out_scale))
    return layers


def _apply(layers, x):
    h = x.float()
    for layer in layers[:-1]:
        h = torch.tanh(_dense(layer, h))
    return _dense(layers[-1], h)


class SACModule(RLModule):
    """Squashed-Gaussian actor + twin Q critics.

    Actions live in [-1, 1] module-side and are affinely mapped to the
    env's Box bounds (``to_env``), so stored transitions hold env actions
    and the learner maps them back."""

    def __init__(self, obs_dim: int, act_dim: int,
                 low: np.ndarray, high: np.ndarray, hiddens=(256, 256)):
        self.obs_dim = obs_dim
        self.act_dim = act_dim
        self.hiddens = tuple(hiddens)
        self._scale_np = np.asarray((high - low) / 2.0, np.float32)
        self._center_np = np.asarray((high + low) / 2.0, np.float32)
        self._bounds_on: Dict[torch.device, Tuple[torch.Tensor,
                                                  torch.Tensor]] = {}

    def bounds(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """(scale, center) of the env's Box on ``device``."""
        device = torch.device(device)
        if device not in self._bounds_on:
            self._bounds_on[device] = (
                torch.as_tensor(self._scale_np).to(device),
                torch.as_tensor(self._center_np).to(device))
        return self._bounds_on[device]

    def init(self, generator: torch.Generator):
        sizes = (self.obs_dim,) + self.hiddens
        q_sizes = (self.obs_dim + self.act_dim,) + self.hiddens
        return {
            "actor": _mlp(generator, sizes, 2 * self.act_dim, out_scale=0.01),
            "q1": _mlp(generator, q_sizes, 1),
            "q2": _mlp(generator, q_sizes, 1),
            "log_alpha": torch.tensor(0.0, device=generator.device),
        }

    # ------------------------------------------------------------- policy

    def _dist(self, params, obs):
        mu, log_std = _apply(params["actor"], obs).chunk(2, dim=-1)
        return mu, log_std.clamp(_LOG_STD_MIN, _LOG_STD_MAX)

    def sample_action(self, params, obs, generator,
                      noise: Optional[torch.Tensor] = None):
        """Reparameterized squashed sample -> (action, log_prob). ``noise``
        (standard normal, the actions' shape) replaces the generator's
        draw."""
        mu, log_std = self._dist(params, obs)
        eps = noise if noise is not None else torch.randn(
            mu.shape, generator=generator, device=mu.device)
        pre = mu + log_std.exp() * eps
        act = torch.tanh(pre)
        # log N(pre) - log |d tanh/d pre|, summed over action dims
        # (squash correction in its numerically-stable softplus form).
        logp_gauss = -0.5 * (eps ** 2 + 2 * log_std
                             + math.log(2 * math.pi)).sum(-1)
        corr = (2 * (math.log(2.0) - pre - F.softplus(-2 * pre))).sum(-1)
        return act, logp_gauss - corr

    def q_values(self, params, obs, act):
        x = torch.cat([obs.float(), act], dim=-1)
        return _apply(params["q1"], x)[..., 0], _apply(params["q2"], x)[..., 0]

    def to_env(self, act: torch.Tensor) -> torch.Tensor:
        scale, center = self.bounds(act.device)
        return act * scale + center

    def from_env(self, act: torch.Tensor) -> torch.Tensor:
        """Env actions back to module actions, inside (-1, 1)."""
        scale, center = self.bounds(act.device)
        return ((act - center) / scale).clamp(-0.999, 0.999)

    # ------------------------------------- runner protocol (RLModule API)

    def forward(self, params, obs):
        mu, _ = self._dist(params, obs)
        q1, q2 = self.q_values(params, obs, torch.tanh(mu))
        return {"logits": mu, "vf": torch.minimum(q1, q2)}

    def forward_exploration(self, params, obs, generator):
        act, logp = self.sample_action(params, obs, generator)
        q1, q2 = self.q_values(params, obs, act)
        return self.to_env(act), logp, torch.minimum(q1, q2)


def _detached(tree):
    return tree_map(lambda t: t.detach(), tree)


class SACLearner(TorchLearner):
    per_row_metrics = ("td_abs",)
    replicated_metrics = ("alpha",)

    def __init__(self, module: SACModule, cfg: SACConfig, **kw):
        self.cfg = cfg
        self._target_entropy = (
            cfg.target_entropy if cfg.target_entropy is not None
            else -float(module.act_dim))
        super().__init__(module, lr=cfg.lr, grad_clip=cfg.grad_clip, **kw)
        if cfg.initial_alpha != 1.0:
            with torch.no_grad():
                self.params["log_alpha"].fill_(math.log(cfg.initial_alpha))
        # REAL copies, not aliases: the params update in place.
        self._target_q = {k: tree_map(lambda t: t.detach().clone(),
                                      self.params[k]) for k in ("q1", "q2")}

    def _target(self, params, batch, generator, noise):
        """The critic target y = r + gamma (1-d) [min tQ(s',a') - alpha
        log pi(a'|s')], detached."""
        with torch.no_grad():
            next_act, next_logp = self.module.sample_action(
                params, batch["next_obs"], generator, noise)
            tq1, tq2 = self.module.q_values(self._target_q, batch["next_obs"],
                                            next_act)
            alpha = params["log_alpha"].exp()
            return batch["rewards"] + self.cfg.gamma * (
                1.0 - batch["dones"]) * (torch.minimum(tq1, tq2)
                                         - alpha * next_logp)

    def loss(self, params, batch, generator,
             noise: Dict[str, torch.Tensor]):
        """``noise``: {"next": [B, A], "pi": [B, A]} standard normals for
        the target's and the actor term's samples (the reference's
        ``r_next, r_pi = split(rng)``)."""
        m: SACModule = self.module
        obs = batch["obs"]
        # Stored actions are env actions: back to module actions.
        act = m.from_env(batch["actions"])
        alpha = params["log_alpha"].exp()
        y = self._target(params, batch, generator, noise["next"])

        # --- critic
        q1, q2 = m.q_values(params, obs, act)
        critic_err = (q1 - y) ** 2 + (q2 - y) ** 2
        td_abs = (torch.minimum(q1, q2) - y).detach().abs()
        if "weights" in batch:
            critic_err = batch["weights"] * critic_err
        # Means over the whole minibatch (every rank's rows on a mesh).
        n = self.mask_sum(torch.ones_like(q1))
        critic_loss = 0.5 * critic_err.sum() / n

        # --- actor: a log pi - min Q (the critics' params detached keep
        # dQ/da while killing dQ/dtheta_Q)
        pi_act, pi_logp = m.sample_action(params, obs, generator,
                                          noise["pi"])
        frozen = {"q1": _detached(params["q1"]),
                  "q2": _detached(params["q2"])}
        fq1, fq2 = m.q_values(frozen, obs, pi_act)
        actor_loss = (alpha.detach() * pi_logp
                      - torch.minimum(fq1, fq2)).sum() / n

        # --- temperature: drive E[-log pi] toward the target entropy
        alpha_loss = -(params["log_alpha"]
                       * (pi_logp.detach() + self._target_entropy)).sum() / n

        loss = critic_loss + actor_loss + alpha_loss
        return loss, {
            "critic_loss": critic_loss,
            "actor_loss": actor_loss,
            "alpha_loss": alpha_loss,
            "alpha": alpha,
            "mean_q": q1.detach().sum() / n,
            "entropy": -pi_logp.detach().sum() / n,
            "td_abs": td_abs,
        }

    def _polyak(self) -> None:
        tau = self.cfg.tau
        with torch.no_grad():
            for k in ("q1", "q2"):
                tgt = tree_leaves(self._target_q[k])
                # (1 - tau) * t + tau * s, the reference's form (lerp
                # rounds otherwise).
                torch._foreach_mul_(tgt, 1.0 - tau)
                torch._foreach_add_(tgt, tree_leaves(self.params[k]),
                                    alpha=tau)

    def draw_noise(self, n: int) -> Dict[str, torch.Tensor]:
        """The loss's draws for an ``n``-row minibatch, from the learner's
        generator in the order the loss would draw them."""
        shape = (n, self.module.act_dim)
        return {k: torch.randn(shape, generator=self._generator,
                               device=self.device) for k in ("next", "pi")}

    def update_sac(self, batch: Dict[str, np.ndarray],
                   noise: Optional[Dict[str, Any]] = None
                   ) -> Dict[str, float]:
        """One update on one minibatch, then the polyak step. ``noise``:
        as :meth:`loss` (arrays or tensors), else :meth:`draw_noise`'s.
        On a mesh each rank takes its rows of the minibatch and of the
        whole minibatch's noise, so the draws are one device's."""
        n = len(batch["rewards"])
        noise = self.draw_noise(n) if noise is None else noise
        metrics = self._step(self._to_device(self._local_batch(batch, n)),
                             noise=self._to_device(
                                 self._local_batch(noise, n)))
        self._polyak()
        return mean_metrics([metrics])

    @torch.no_grad()
    def td_errors(self, batch: Dict[str, np.ndarray]) -> np.ndarray:
        """|min-Q TD error| for prioritized replay."""
        dev = self._to_device({k: v for k, v in batch.items()
                               if k != "weights"})
        y = self._target(self.params, dev, self._generator, None)
        q1, q2 = self.module.q_values(self.params, dev["obs"],
                                      self.module.from_env(dev["actions"]))
        return (torch.minimum(q1, q2) - y).abs().cpu().numpy()


class SAC(Algorithm):
    config_cls = SACConfig

    def _spaces(self) -> Tuple[Tuple[int, ...], int, np.ndarray, np.ndarray]:
        obs_space, space = env_spaces(self._algo_config.make_env_creator())
        low = np.asarray(space.low, np.float32)
        high = np.asarray(space.high, np.float32)
        return (tuple(obs_space.shape), int(np.prod(space.shape)), low,
                high)

    def _module_factory(self):
        cfg = self._algo_config
        obs_shape, act_dim, low, high = self._spaces()
        obs_dim = int(np.prod(obs_shape))
        hiddens = tuple(cfg.model.get("fcnet_hiddens", (256, 256)))

        # A partial of the class: it goes by plain pickle to a process.
        return functools.partial(SACModule, obs_dim, act_dim, low, high,
                                 hiddens)

    def _learner_factory(self):
        cfg = self._algo_config
        return LearnerFactory(SACLearner, self._module_factory(), cfg,
                              mesh=cfg.learner_mesh, seed=cfg.seed,
                              device=cfg.device)

    def _setup_extra(self) -> None:
        cfg = self._algo_config
        obs_shape, act_dim, _, _ = self._spaces()
        self._buffer = make_buffer(
            cfg.replay_buffer_config, cfg.replay_buffer_capacity, obs_shape,
            action_shape=(act_dim,), action_dtype=np.float32)
        self._np_rng = np.random.default_rng(cfg.seed)

    def training_step(self) -> Dict[str, Any]:
        cfg = self._algo_config
        if not hasattr(self, "_buffer"):
            self._setup_extra()
        t0 = time.perf_counter()
        weights = self.learner_group.get_weights()
        self.env_runner_group.sync_weights(weights)

        episodes = self.env_runner_group.sample(cfg.train_batch_size)
        self._record_episodes(episodes)
        episodes = self._connect_episodes(episodes)
        # Env steps, not stored transitions: the buffer drops a step whose
        # next observation the env never returned.
        steps = sum(len(e) for e in episodes)
        self._buffer.add_episodes(episodes)
        t1 = time.perf_counter()

        metrics: Dict[str, Any] = {}
        if self._buffer.size >= cfg.learning_starts:
            prioritized = isinstance(self._buffer, PrioritizedReplayBuffer)
            for _ in range(cfg.num_updates_per_iter):
                batch = self._buffer.sample(cfg.minibatch_size, self._np_rng)
                idx = batch.pop("idx", None)
                metrics = self.learner_group.call("update_sac", batch)
                if prioritized and idx is not None:
                    td = self.learner_group.call("take_td_errors")
                    if len(td):
                        self._buffer.update_priorities(idx, td)

        out = dict(metrics)
        out["buffer_size"] = self._buffer.size
        out["episode_return_mean"] = self.episode_return_mean
        out["num_episodes"] = len(episodes)
        out["env_steps_this_iter"] = steps
        # Host-clock seconds of the sampling and of the updates.
        out["sample_time_s"] = t1 - t0
        out["learn_time_s"] = time.perf_counter() - t1
        return out
