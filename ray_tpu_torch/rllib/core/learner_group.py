"""LearnerGroup: the local learner (counterpart of the JAX package's
``rllib/core/learner_group.py``). ``num_learners=0`` runs the learner in
the calling process, where the learner's device (and mesh) do the scaling.
Actor-hosted learners are framework glue not yet ported (ROADMAP item G):
asking for them raises."""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional


class LearnerGroup:
    def __init__(
        self,
        learner_factory: Callable[[], Any],
        *,
        num_learners: int = 0,
        learner_resources: Optional[Dict[str, float]] = None,
    ):
        if num_learners > 0:
            raise NotImplementedError(
                "actor-hosted learners (num_learners > 0) are framework "
                "glue not yet ported (ROADMAP item G); use num_learners=0")
        self._learner = learner_factory()

    @property
    def learner(self) -> Any:
        return self._learner

    def update(self, batch, **kw) -> Dict[str, float]:
        return self._learner.update(batch, **kw)

    def call(self, method: str, *args, **kw) -> Any:
        """Invoke an algorithm-specific learner method."""
        return getattr(self._learner, method)(*args, **kw)

    def get_weights(self) -> Any:
        return self._learner.get_weights()

    def set_weights(self, w) -> None:
        self._learner.set_weights(w)

    def get_state(self) -> Dict[str, Any]:
        return self._learner.get_state()

    def set_state(self, state) -> None:
        self._learner.set_state(state)

    def shutdown(self) -> None:
        pass
