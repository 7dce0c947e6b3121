"""DAG authoring: lazy task and actor call graphs built with ``.bind()``
(counterpart of the JAX package's ``dag/dag_node.py``, ported whole).

``fn.bind(x)`` returns a node instead of submitting, and
``node.execute(input)`` walks the graph and submits everything through
the core's API (``core/api.py``), with one memo per execution, so a
diamond's shared parent runs once. Refs flow between the calls inside
the driver: the driver resolves a call's ref arguments before it sends
the call. ``dag/compiled_dag.py`` compiles such a graph into persistent
actor pipelines.
"""
from __future__ import annotations

import itertools
from typing import Any, Dict, List, Optional, Tuple

_ANON = itertools.count()


class DAGNode:
    """One lazy call in an authored graph.

    Subclasses define what submitting the call means in
    ``_execute_impl``. ``execute`` resolves upstream nodes first (memoized
    in ``memo``) and passes their ObjectRefs downstream.
    """

    def __init__(self, args: Tuple[Any, ...], kwargs: Dict[str, Any]):
        self._bound_args = args
        self._bound_kwargs = kwargs

    # -- traversal ---------------------------------------------------------
    def _upstream(self) -> List["DAGNode"]:
        found: List[DAGNode] = []

        def scan(v):
            if isinstance(v, DAGNode):
                found.append(v)
            elif isinstance(v, (list, tuple)):
                for x in v:
                    scan(x)
            elif isinstance(v, dict):
                for x in v.values():
                    scan(x)

        for a in self._bound_args:
            scan(a)
        for a in self._bound_kwargs.values():
            scan(a)
        return found

    def topological(self) -> List["DAGNode"]:
        """All nodes reachable from (and including) self, deps first."""
        order: List[DAGNode] = []
        seen: set = set()

        def visit(n: DAGNode):
            if id(n) in seen:
                return
            seen.add(id(n))
            for up in n._upstream():
                visit(up)
            order.append(n)

        visit(self)
        return order

    def _resolve_value(self, v: Any, memo: Dict[int, Any]) -> Any:
        if isinstance(v, DAGNode):
            return v._execute_memo(memo)
        if isinstance(v, list):
            return [self._resolve_value(x, memo) for x in v]
        if isinstance(v, tuple):
            return tuple(self._resolve_value(x, memo) for x in v)
        if isinstance(v, dict):
            return {k: self._resolve_value(x, memo) for k, x in v.items()}
        return v

    def _resolved_args(self, memo: Dict[int, Any]) -> Tuple[tuple, dict]:
        args = tuple(self._resolve_value(a, memo) for a in self._bound_args)
        kwargs = {
            k: self._resolve_value(v, memo)
            for k, v in self._bound_kwargs.items()
        }
        return args, kwargs

    # -- execution ---------------------------------------------------------
    def _execute_memo(self, memo: Dict[int, Any]) -> Any:
        if id(self) not in memo:
            memo[id(self)] = self._execute_impl(memo)
        return memo[id(self)]

    def execute(self, *input_args, **input_kwargs) -> Any:
        """Submit the whole graph; returns the ref(s) of this output node."""
        memo: Dict[int, Any] = {"__input__": (input_args, input_kwargs)}
        return self._execute_memo(memo)

    def _execute_impl(self, memo: Dict[int, Any]) -> Any:
        raise NotImplementedError

    # -- naming (stable ids for durable workflows) -------------------------
    def _name_hint(self) -> str:
        return f"node_{next(_ANON)}"


class FunctionNode(DAGNode):
    """``remote_fn.bind(*args)`` — a task submission deferred."""

    def __init__(self, remote_fn, args, kwargs, options: Optional[dict] = None):
        super().__init__(args, kwargs)
        self._remote_fn = remote_fn
        self._options = dict(options or {})

    def options(self, **opts) -> "FunctionNode":
        merged = dict(self._options)
        merged.update(opts)
        return FunctionNode(self._remote_fn, self._bound_args,
                            self._bound_kwargs, merged)

    def _execute_impl(self, memo):
        args, kwargs = self._resolved_args(memo)
        fn = self._remote_fn
        if self._options:
            fn = fn.options(**self._options)
        return fn.remote(*args, **kwargs)

    def _name_hint(self) -> str:
        fn = getattr(self._remote_fn, "_fn", None)
        return getattr(fn, "__name__", "task")


class ClassNode(DAGNode):
    """``ActorClass.bind(*args)`` — deferred actor construction.

    Within one ``execute`` (or one workflow run) the actor is created once
    and shared by all method nodes hanging off it.
    """

    def __init__(self, actor_cls, args, kwargs, options: Optional[dict] = None):
        super().__init__(args, kwargs)
        self._actor_cls = actor_cls
        self._options = dict(options or {})

    def options(self, **opts) -> "ClassNode":
        merged = dict(self._options)
        merged.update(opts)
        return ClassNode(self._actor_cls, self._bound_args,
                         self._bound_kwargs, merged)

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return _BoundMethod(self, name)

    def _execute_impl(self, memo):
        args, kwargs = self._resolved_args(memo)
        cls = self._actor_cls
        if self._options:
            cls = cls.options(**self._options)
        return cls.remote(*args, **kwargs)

    def _name_hint(self) -> str:
        cls = getattr(self._actor_cls, "_cls", None)
        return getattr(cls, "__name__", "actor")


class _BoundMethod:
    def __init__(self, owner: ClassNode, method: str):
        self._owner = owner
        self._method = method

    def bind(self, *args, **kwargs) -> "ClassMethodNode":
        return ClassMethodNode(self._owner, self._method, args, kwargs)


class ClassMethodNode(DAGNode):
    """``class_node.method.bind(*args)`` — deferred actor method call."""

    def __init__(self, owner, method: str, args, kwargs):
        super().__init__(args, kwargs)
        self._owner = owner  # ClassNode or ActorHandle
        self._method = method

    @property
    def owner(self):
        """The ClassNode (deferred actor) or live ActorHandle this method
        dispatches on — the channel compiler keys stages by it."""
        return self._owner

    @property
    def method_name(self) -> str:
        return self._method

    def _upstream(self) -> List[DAGNode]:
        ups = super()._upstream()
        if isinstance(self._owner, DAGNode):
            ups.append(self._owner)
        return ups

    def _execute_impl(self, memo):
        owner = self._owner
        handle = owner._execute_memo(memo) if isinstance(owner, DAGNode) \
            else owner
        args, kwargs = self._resolved_args(memo)
        return getattr(handle, self._method).remote(*args, **kwargs)

    def _name_hint(self) -> str:
        return self._method


class InputNode(DAGNode):
    """Placeholder for the value passed to ``execute()`` / each workflow run.

    Usable as a context manager (``with InputNode() as inp:``).
    ``inp[k]`` / ``inp.attr`` select into a dict or positional input.
    """

    def __init__(self):
        super().__init__((), {})

    def __enter__(self) -> "InputNode":
        return self

    def __exit__(self, *exc):
        return False

    def __getitem__(self, key) -> "InputAttributeNode":
        return InputAttributeNode(self, key)

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return InputAttributeNode(self, name)

    def _execute_impl(self, memo):
        args, kwargs = memo.get("__input__", ((), {}))
        if kwargs and args:
            # Returning only args would make inp['key'] selectors read the
            # wrong data: the ambiguous mix is refused.
            raise TypeError(
                "DAG execute() got both positional and keyword inputs; "
                "pass one or the other (use a dict input for named access)")
        if kwargs and not args:
            return kwargs
        if len(args) == 1 and not kwargs:
            return args[0]
        return args

    def _name_hint(self) -> str:
        return "input"


class InputAttributeNode(DAGNode):
    def __init__(self, parent: InputNode, key):
        super().__init__((), {})
        self._parent = parent
        self._key = key

    @property
    def key(self):
        """The selector applied to the execute() input. Channel mode sends
        the whole input once per seq and applies this at the consumer."""
        return self._key

    def _upstream(self) -> List[DAGNode]:
        return [self._parent]

    def _execute_impl(self, memo):
        val = self._parent._execute_memo(memo)
        if isinstance(self._key, int) and isinstance(val, (list, tuple)):
            return val[self._key]
        if isinstance(val, dict):
            return val[self._key]
        return getattr(val, self._key)

    def _name_hint(self) -> str:
        return f"input.{self._key}"


class MultiOutputNode(DAGNode):
    """Bundle several leaves so ``execute`` returns a list of refs."""

    def __init__(self, outputs: List[DAGNode]):
        super().__init__((tuple(outputs),), {})
        self._outputs = list(outputs)

    @property
    def outputs(self) -> List[DAGNode]:
        return list(self._outputs)

    def _execute_impl(self, memo):
        return [o._execute_memo(memo) for o in self._outputs]

    def _name_hint(self) -> str:
        return "multi_output"
