"""DAG authoring and compiled actor pipelines (counterpart of the JAX
package's ``dag/``): ``.bind()`` graphs executed through the core's API
(``dag_node.py``), and graphs compiled onto shared-memory channels with a
resident loop in each stage actor's process (``compiled_dag.py``,
``channels.py``, ``resident.py``, ``meter.py``). One host."""
from .channels import DAGTeardownError
from .compiled_dag import (ChannelDAGRef, CompiledDAG, CompiledDAGRef,
                           compile_dag)
from .dag_node import (ClassMethodNode, ClassNode, DAGNode, FunctionNode,
                       InputAttributeNode, InputNode, MultiOutputNode)

__all__ = [
    "DAGNode",
    "FunctionNode",
    "ClassNode",
    "ClassMethodNode",
    "InputNode",
    "InputAttributeNode",
    "MultiOutputNode",
    "CompiledDAG",
    "CompiledDAGRef",
    "ChannelDAGRef",
    "DAGTeardownError",
    "compile_dag",
]
