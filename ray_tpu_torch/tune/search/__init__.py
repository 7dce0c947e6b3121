"""Search: spaces, variant generation, searcher interface (the port's copy
of the JAX package's ``tune/search``)."""
from .sample import (
    Categorical,
    Domain,
    Float,
    Integer,
    choice,
    grid_search,
    loguniform,
    qrandint,
    randint,
    randn,
    uniform,
)
from .searcher import ConcurrencyLimiter, Searcher
from .basic_variant import BasicVariantGenerator
from .tpe import TPESearcher

__all__ = [
    "BasicVariantGenerator",
    "TPESearcher",
    "Categorical",
    "ConcurrencyLimiter",
    "Domain",
    "Float",
    "Integer",
    "Searcher",
    "choice",
    "grid_search",
    "loguniform",
    "qrandint",
    "randint",
    "randn",
    "uniform",
]
