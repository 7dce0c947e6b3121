from .io import (JsonWriter, read_experiences, write_fragments,
                 write_transitions)
from .bc import BC, BCConfig
from .cql import CQL, CQLConfig
from .marwil import MARWIL, MARWILConfig

__all__ = ["BC", "BCConfig", "CQL", "CQLConfig", "MARWIL", "MARWILConfig",
           "JsonWriter", "read_experiences", "write_fragments",
           "write_transitions"]
