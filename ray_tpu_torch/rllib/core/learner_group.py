"""LearnerGroup: the learner in this process or in a learner process
(counterpart of the JAX package's ``rllib/core/learner_group.py``).

Parity: reference rllib/core/learner/learner_group.py:69 (update_from_batch
:219, remote learner actors :178). As in the JAX package, ONE learner
process whatever ``num_learners`` > 0 asks for: the learner's device (and
mesh) do the scaling, so ``num_learners`` chooses where the learner lives,
not a second collective system. ``num_learners=0`` builds it here.

The learner process (``utils/actor_manager.py``) hosts the factory's
learner itself and takes card 0 unless the learner's ``device`` is the
CPU, where it runs torch on the calling process's thread count. The
learner factory goes by plain pickle (a nested function raises before any
spawn), batches travel as files, weights and state come back as numpy
trees. A learner that fails to build raises here with the
process's traceback, and no process is left.

On the CPU: ``tests/test_torch_rllib_remote.py``; on the card,
``chip_smoke.py``'s ``ppo_remote`` runs PPO's learner in this process
type (``PPOConfig().learners(num_learners=1)``).
"""
from __future__ import annotations

import shutil
import tempfile
from typing import Any, Callable, Dict, Optional

import torch

from ...device import DeviceLike
from ...util import procs
from ..utils.actor_manager import ActorProcess, actor_payload


# The learner methods whose dict arguments are batches: they travel as
# files.
_BATCH_METHODS = ("update", "update_td", "update_sac")


def _learner_card(device: DeviceLike) -> Optional[int]:
    """The learner process's card (None: the CPU); raises, before any
    spawn, where the card is asked for (or implied) and CUDA is absent."""
    if device is not None and torch.device(device).type == "cpu":
        return None
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the learner process on the CPU")
    dev = torch.device("cuda" if device is None else device)
    return 0 if dev.index is None else dev.index


class LearnerGroup:
    def __init__(
        self,
        learner_factory: Callable[[], Any],
        *,
        num_learners: int = 0,
        device: DeviceLike = None,
    ):
        """num_learners=0: the learner lives in this process.
        num_learners >= 1: one learner process, on ``device`` (the card
        unless the caller asks for the CPU; the factory's learner should
        be built for the same device)."""
        self._actor: Optional[ActorProcess] = None
        self._learner = None
        if num_learners <= 0:
            self._learner = learner_factory()
            return
        card = _learner_card(device)
        payload = actor_payload(learner_factory, where="the learner process")
        self._spill_dir = tempfile.mkdtemp(prefix="rtpu-learner-")
        try:
            self._actor = ActorProcess(
                payload, "rtpu-learner", spill_dir=self._spill_dir,
                card=card, num_threads=torch.get_num_threads(),
                spill_args=_BATCH_METHODS)
            # Fail fast, with the process's traceback, if the learner
            # cannot build.
            self._actor.call("process_info")
        except BaseException:
            self.shutdown()
            raise

    @property
    def learner(self) -> Any:
        """The learner object (None where it lives in a learner
        process)."""
        return self._learner

    @property
    def actor(self) -> Optional[ActorProcess]:
        """The learner process's handle (None where it lives here)."""
        return self._actor

    def update(self, batch, **kw) -> Dict[str, float]:
        if self._actor is not None:
            return self._actor.call("update", batch, **kw)
        return self._learner.update(batch, **kw)

    def call(self, method: str, *args, **kw) -> Any:
        """Invoke an algorithm-specific learner method (e.g. DQN's
        update_td) in whichever process hosts the learner."""
        if self._actor is not None:
            return self._actor.call(method, *args, **kw)
        return getattr(self._learner, method)(*args, **kw)

    def get_weights(self) -> Any:
        if self._actor is not None:
            return self._actor.call("get_weights")
        return self._learner.get_weights()

    def set_weights(self, w) -> None:
        if self._actor is not None:
            self._actor.call("set_weights", w)
        else:
            self._learner.set_weights(w)

    def get_state(self) -> Dict[str, Any]:
        if self._actor is not None:
            return self._actor.call("get_state")
        return self._learner.get_state()

    def set_state(self, state) -> None:
        if self._actor is not None:
            self._actor.call("set_state", state)
        else:
            self._learner.set_state(state)

    def shutdown(self) -> None:
        """Stop the learner process, if any; none is left behind."""
        if self._actor is not None:
            procs.stop([self._actor])
            self._actor = None
        if hasattr(self, "_spill_dir"):
            shutil.rmtree(self._spill_dir, ignore_errors=True)
