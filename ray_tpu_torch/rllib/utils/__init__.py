from .episodes import SingleAgentEpisode, episodes_to_batch
from .gae import compute_gae, vtrace

__all__ = [
    "SingleAgentEpisode",
    "episodes_to_batch",
    "compute_gae",
    "vtrace",
]
