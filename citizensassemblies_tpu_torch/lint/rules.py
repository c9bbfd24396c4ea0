"""The port's AST rules R1-R5 and R7-R13 (R6 is ``config_rule.py``).

Each rule is the torch counterpart of the JAX package's rule of the same
id, small and self-contained; shared helpers (dotted-name resolution,
parent maps, the tensor-valued-expression heuristic) live at the top. The
rules are heuristic where they must be (static reachability, whether an
expression is a tensor) and every false positive has an explicit escape:
``# graftlint: disable=Rn -- reason``.
"""

from __future__ import annotations

import ast
import functools
from typing import Dict, List, Optional, Sequence, Set, Tuple

from citizensassemblies_tpu_torch.lint.engine import ModuleSource, Violation

# --- shared helpers ---------------------------------------------------------


@functools.lru_cache(maxsize=1 << 16)
def walk(node: ast.AST) -> Tuple[ast.AST, ...]:
    """``ast.walk(node)`` as a tuple, memoized: the rules walk the same
    subtrees many times."""
    return tuple(ast.walk(node))


def dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for Name/Attribute chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _last(node: ast.AST) -> str:
    d = dotted(node)
    return d.rsplit(".", 1)[-1] if d else ""


@functools.lru_cache(maxsize=512)
def parent_map(tree: ast.AST) -> Dict[ast.AST, ast.AST]:
    parents: Dict[ast.AST, ast.AST] = {}
    for node in walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    return parents


def enclosing(node: ast.AST, parents, kinds) -> Optional[ast.AST]:
    cur = parents.get(node)
    while cur is not None:
        if isinstance(cur, kinds):
            return cur
        cur = parents.get(cur)
    return None


@functools.lru_cache(maxsize=512)
def numpy_aliases(tree: ast.Module) -> Set[str]:
    """Names bound to the ``numpy`` module (``np`` usually)."""
    out: Set[str] = set()
    for node in walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name == "numpy":
                    out.add(alias.asname or "numpy")
    return out


@functools.lru_cache(maxsize=512)
def torch_aliases(tree: ast.Module) -> Set[str]:
    """Names bound to the ``torch`` module."""
    out: Set[str] = {"torch"}
    for node in walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name == "torch":
                    out.add(alias.asname or "torch")
    return out


@functools.lru_cache(maxsize=512)
def module_names(tree: ast.Module) -> Set[str]:
    """Names bound at module level (containers a memo may store into)."""
    out: Set[str] = set()
    for node in tree.body:
        if isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            out.add(node.target.id)
    return out


def _is_test_module(mod: ModuleSource) -> bool:
    name = mod.path.name
    return "tests" in mod.path.parts or name.startswith("test_") or name == "conftest.py"


def _rel(mod: ModuleSource) -> str:
    return str(mod.path).replace("\\", "/")


def _viol(mod: ModuleSource, node: ast.AST, rule, message: str) -> Violation:
    return Violation(
        path=mod.rel, line=node.lineno, col=node.col_offset,
        rule=rule.rule_id, name=rule.name, message=message,
    )


#: tensor methods whose result is a tensor (the tensor-valued heuristic)
_TENSOR_METHODS = frozenset({
    "sum", "max", "min", "amax", "amin", "any", "all", "mean", "norm", "abs", "sqrt",
    "clamp", "clamp_min", "clamp_max", "to", "float", "double", "half", "reshape", "view",
    "contiguous", "clone", "detach", "t", "matmul", "argmax", "argmin", "count_nonzero",
    "isfinite", "isnan", "nonzero", "masked_select", "cumsum", "prod", "square",
})


def tensor_names(fn: ast.AST, torch_alias: Set[str]) -> Set[str]:
    """Names a function binds to tensor-valued expressions, to a fixpoint
    (a heuristic: ``x = torch.…(…)``, ``x = y.sum()``, arithmetic on
    tensors)."""
    names: Set[str] = set()
    assigns = [node for node in walk(fn) if isinstance(node, ast.Assign)]
    changed = True
    while changed:
        changed = False
        for node in assigns:
            if is_tensor_expr(node.value, names, torch_alias):
                for t in node.targets:
                    if isinstance(t, ast.Name) and t.id not in names:
                        names.add(t.id)
                        changed = True
    return names


def is_tensor_expr(node: ast.AST, names: Set[str], torch_alias: Set[str]) -> bool:
    """Is ``node`` (heuristically) a tensor value?"""
    if isinstance(node, ast.Name):
        return node.id in names
    if isinstance(node, ast.Call):
        func = node.func
        d = dotted(func)
        if d is not None:
            head = d.split(".", 1)[0]
            if head in torch_alias and "." in d:
                last = d.rsplit(".", 1)[-1]
                # torch.cuda.*, torch.device(...), torch.Generator(...) are
                # not tensors
                return not d.startswith(f"{head}.cuda") and last[:1].islower()
        if isinstance(func, ast.Attribute) and func.attr in _TENSOR_METHODS:
            return is_tensor_expr(func.value, names, torch_alias)
        return False
    if isinstance(node, ast.Subscript):
        return is_tensor_expr(node.value, names, torch_alias)
    if isinstance(node, ast.BinOp):
        return is_tensor_expr(node.left, names, torch_alias) or is_tensor_expr(
            node.right, names, torch_alias)
    if isinstance(node, ast.UnaryOp):
        return is_tensor_expr(node.operand, names, torch_alias)
    if isinstance(node, ast.Compare):
        if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn)) for op in node.ops):
            return False
        return any(is_tensor_expr(n, names, torch_alias) for n in [node.left] + node.comparators)
    if isinstance(node, ast.BoolOp):
        return any(is_tensor_expr(v, names, torch_alias) for v in node.values)
    return False


def _with_calls(node: ast.With) -> List[str]:
    """Last name of each context manager call of a ``with``."""
    out = []
    for item in node.items:
        expr = item.context_expr
        if isinstance(expr, ast.Call):
            out.append(_last(expr.func))
    return out


# --- R1: host syncs inside a launch window ----------------------------------


class HostSyncInLaunchWindowRule:
    """R1 — a host-synchronising call reachable from code that runs inside
    a launch window.

    Roots: the bodies of ``with guarded_launch(...)`` and ``with
    no_implicit_transfers(...)`` (the transfer guard's windows and armed
    sites), the graph store's block factories (``@register_block``, whose
    blocks a CUDA graph captures), functions passed to ``SeededGraph`` by
    name, and replay closures (a function whose name says ``replay``).
    Reachability is the closure over same-module calls by bare name.
    Findings: ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
    ``torch.cuda.synchronize``, ``float()``/``int()``/``bool()`` on a
    tensor and ``np.asarray``/``np.array`` on a tensor. ``guards.readback``
    is the legal sync: a call inside ``with readback():`` is not flagged.
    """

    rule_id = "R1"
    name = "host-sync-in-launch-window"
    description = "host-sync call reachable from a launch window"

    _SYNC_ATTRS = {"item", "tolist", "cpu", "numpy"}
    _NP_SYNC_FUNCS = {"asarray", "array"}
    _CAST_BUILTINS = {"float", "int", "bool"}
    _WINDOWS = {"guarded_launch", "no_implicit_transfers"}

    def check_module(self, mod: ModuleSource) -> List[Violation]:
        tree = mod.tree
        np_alias = numpy_aliases(tree)
        th = torch_aliases(tree)
        parents = parent_map(tree)
        table: Dict[str, ast.AST] = {
            node.name: node
            for node in tree.body
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
        }
        roots: List[ast.AST] = []
        for node in walk(tree):
            if isinstance(node, ast.With) and self._WINDOWS & set(_with_calls(node)):
                roots.append(node)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if "replay" in node.name:
                    roots.append(node)
                for dec in node.decorator_list:
                    target = dec.func if isinstance(dec, ast.Call) else dec
                    if _last(target) == "register_block":
                        roots.append(node)
            elif isinstance(node, ast.Call) and _last(node.func) == "SeededGraph":
                for arg in list(node.args) + [kw.value for kw in node.keywords]:
                    if isinstance(arg, ast.Name) and arg.id in table:
                        roots.append(table[arg.id])

        reachable: List[ast.AST] = []
        seen: Set[int] = set()
        work = list(roots)
        while work:
            fn = work.pop()
            if id(fn) in seen:
                continue
            seen.add(id(fn))
            reachable.append(fn)
            for node in walk(fn):
                if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
                    target = table.get(node.func.id)
                    if target is not None and id(target) not in seen:
                        work.append(target)

        out: List[Violation] = []
        flagged: Set[Tuple[int, int]] = set()

        def in_readback(node: ast.AST) -> bool:
            cur = parents.get(node)
            while cur is not None:
                if isinstance(cur, ast.With) and "readback" in _with_calls(cur):
                    return True
                cur = parents.get(cur)
            return False

        for fn in reachable:
            scope = enclosing(fn, parents, (ast.FunctionDef, ast.AsyncFunctionDef))
            names = tensor_names(fn if not isinstance(fn, ast.With) or scope is None else scope, th)
            for node in walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                key = (node.lineno, node.col_offset)
                if key in flagged or in_readback(node):
                    continue
                what = self._sync(node, names, np_alias, th)
                if what is None:
                    continue
                flagged.add(key)
                out.append(_viol(mod, node, self, f"{what} forces a host sync inside a launch window"))
        return out

    def _sync(self, node: ast.Call, names, np_alias, th) -> Optional[str]:
        func = node.func
        if isinstance(func, ast.Attribute) and func.attr in self._SYNC_ATTRS and not node.args:
            return f".{func.attr}()"
        d = dotted(func)
        if d is not None:
            if d.endswith("cuda.synchronize"):
                return f"{d}()"
            head, _, last = d.rpartition(".")
            if head in np_alias and last in self._NP_SYNC_FUNCS and node.args and is_tensor_expr(
                    node.args[0], names, th):
                return f"{d}() on a tensor"
        if (
            isinstance(func, ast.Name) and func.id in self._CAST_BUILTINS and node.args
            and is_tensor_expr(node.args[0], names, th)
        ):
            return f"{func.id}() on a tensor"
        return None


# --- R2: graphs, libraries and compiles constructed per call -----------------


def _has_memo_pattern(fn: ast.AST, mod_names: Set[str]) -> bool:
    """A ``global`` statement, or a store into a module-level container or
    an attribute of ``self`` (a per-object memo)."""
    for node in walk(fn):
        if isinstance(node, ast.Global):
            return True
        if isinstance(node, ast.Assign):
            for t in node.targets:
                base = t.value if isinstance(t, (ast.Subscript, ast.Attribute)) else None
                if isinstance(base, ast.Name) and (base.id in mod_names or base.id == "self"):
                    return True
    return False


def _is_factory(fn: ast.AST, constructed: ast.AST, parents) -> bool:
    """The enclosing function returns the constructed object (directly or
    via the local name it was bound to)."""
    bound: Set[str] = set()
    assign = parents.get(constructed)
    if isinstance(assign, ast.Assign):
        bound.update(t.id for t in assign.targets if isinstance(t, ast.Name))
    for node in walk(fn):
        if isinstance(node, ast.Return) and node.value is not None:
            if any(n is constructed for n in walk(node.value)):
                return True
            if isinstance(node.value, ast.Name) and node.value.id in bound:
                return True
    return False


class PerCallConstructionRule:
    """R2 — one-time work constructed per call.

    A CUDA graph is captured once per signature, by the graph store: a
    ``torch.cuda.CUDAGraph()`` or ``torch.cuda.graph(`` outside
    ``aot/store.py`` captures per call. A kernel library (``CudaLibrary(``,
    ``native_build.build``) built inside a loop, or per call with no memo
    (a ``global``, a store into a module-level container or into ``self``)
    rebuilds per call. ``torch.compile`` is flagged anywhere: the port's
    kernels are written by hand, and a compile is one-time work outside
    every guard.
    """

    rule_id = "R2"
    name = "per-call-construction"
    description = "graph, library or compile constructed per call"

    _STORE_SUFFIX = "aot/store.py"

    def check_module(self, mod: ModuleSource) -> List[Violation]:
        parents = parent_map(mod.tree)
        mod_names = module_names(mod.tree)
        in_store = _rel(mod).endswith(self._STORE_SUFFIX)
        th = torch_aliases(mod.tree)
        out: List[Violation] = []
        for node in walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            d = dotted(node.func) or ""
            if d.endswith(".compile") and d.split(".", 1)[0] in th:
                out.append(_viol(mod, node, self, "torch.compile: a compile is one-time work "
                                 "outside every guard; the port's kernels are hand-written"))
                continue
            if d.endswith("cuda.CUDAGraph") or d.endswith("cuda.graph"):
                if not in_store:
                    out.append(_viol(mod, node, self, f"{d}( outside aot/store.py captures a graph "
                                     "per call; go through the graph store (SeededGraph)"))
                continue
            if d.rsplit(".", 1)[-1] == "CudaLibrary" or d == "native_build.build":
                loop = enclosing(node, parents, (ast.For, ast.While, ast.AsyncFor))
                if loop is not None:
                    out.append(_viol(mod, node, self, f"{d}( inside a loop builds a library per "
                                     "iteration; hoist it to module level or memoize"))
                    continue
                fn = enclosing(node, parents, (ast.FunctionDef, ast.AsyncFunctionDef))
                if fn is None or _has_memo_pattern(fn, mod_names) or _is_factory(fn, node, parents):
                    continue
                out.append(_viol(mod, node, self, f"{d}( per call of '{fn.name}' with no visible "
                                 "memo; hoist it to module level or cache the library"))
        return out


# --- R3: a graph's static output read after the next replay --------------------


class StaticOutputAfterReplayRule:
    """R3 — a view on a captured graph's static output read after a later
    replay of the same graph.

    A replay overwrites its graph's static outputs in place, so a name
    bound to one of them (an alias of ``entry.outs`` or of a tensor bound
    inside a ``torch.cuda.graph`` capture) after one replay holds the next
    replay's values once the graph runs again: the torch counterpart of a
    donated buffer read after its donation. ``.clone()`` breaks the alias.
    Per function, textual order, stopping at a rebind (like the JAX
    package's R3).
    """

    rule_id = "R3"
    name = "static-output-after-replay"
    description = "graph static output read after a later replay"

    def check_module(self, mod: ModuleSource) -> List[Violation]:
        out: List[Violation] = []
        for fn in walk(mod.tree):
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.extend(self._check_fn(mod, fn))
        return out

    @staticmethod
    def _static_names(fn: ast.AST) -> Set[str]:
        names: Set[str] = set()
        for node in walk(fn):
            if isinstance(node, ast.With) and any(c == "graph" for c in _with_calls(node)):
                for st in node.body:
                    for n in walk(st):
                        if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store):
                            names.add(n.id)
        return names

    def _check_fn(self, mod: ModuleSource, fn: ast.AST) -> List[Violation]:
        static = self._static_names(fn)
        replays: List[Tuple[Tuple[int, int], str]] = []
        for node in walk(fn):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "replay"):
                replays.append(((node.lineno, node.col_offset), dotted(node.func.value) or "?"))
        if len(replays) < 2:
            return []
        replays.sort()

        def aliases_static(value: ast.AST) -> bool:
            if isinstance(value, ast.Call):
                return False  # .clone(), or any call, makes a new tensor
            for n in walk(value):
                if isinstance(n, ast.Attribute) and n.attr == "outs":
                    return True
                if isinstance(n, ast.Name) and n.id in static:
                    return True
            return False

        # names bound to a static-output alias after some replay, by position
        bindings: List[Tuple[Tuple[int, int], str, str]] = []
        for node in walk(fn):
            if isinstance(node, ast.Assign) and aliases_static(node.value):
                pos = (node.lineno, node.col_offset)
                before = [g for p, g in replays if p < pos]
                if not before:
                    continue
                for t in node.targets:
                    for n in walk(t):
                        if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store):
                            bindings.append((pos, n.id, before[-1]))
        out: List[Violation] = []
        refs = sorted(
            ((n.lineno, n.col_offset), n) for n in walk(fn) if isinstance(n, ast.Name)
        )
        for bpos, name, graph in bindings:
            later = [p for p, g in replays if p > bpos and g == graph]
            if not later:
                continue
            rp = later[0]
            for pos, ref in refs:
                if pos <= bpos or ref.id != name:
                    continue
                if isinstance(ref.ctx, ast.Store):
                    break
                if pos > rp:
                    out.append(_viol(
                        mod, ref, self,
                        f"'{name}' aliases a static output of '{graph}' and is read after its "
                        f"replay at line {rp[0]}: it now holds that replay's values; .clone() it "
                        "before the next replay",
                    ))
                    break
        return out


# --- R4: float64 discipline ---------------------------------------------------


class DtypeDisciplineRule:
    """R4 — float64 only in the host certification modules, and no float32
    casts inside them.

    The port's device paths are float32 (the card's float64 rate is a
    fraction of its float32 rate, and the JAX package runs with x64 off):
    ``torch.float64``, ``.double()`` and ``dtype=torch.float64`` belong in
    the certification modules only (the JAX rule's allow-list,
    ``solvers/lp_util.py`` and ``solvers/compositions.py``). Inside those,
    a ``torch.float32`` or ``np.float32`` cast quietly downgrades an accept
    threshold.
    """

    rule_id = "R4"
    name = "dtype-discipline"
    description = "float64/float32 discipline of the certification paths"

    _F64_WHITELIST = ("solvers/lp_util.py", "solvers/compositions.py")

    def check_module(self, mod: ModuleSource) -> List[Violation]:
        th = torch_aliases(mod.tree)
        np_alias = numpy_aliases(mod.tree)
        in_whitelist = any(mod.rel.replace("\\", "/").endswith(w) for w in self._F64_WHITELIST)
        out: List[Violation] = []
        for node in walk(mod.tree):
            if isinstance(node, ast.Attribute):
                base = dotted(node.value)
                if node.attr in ("float64", "double") and base in th and not in_whitelist:
                    out.append(_viol(mod, node, self, (
                        f"torch.{node.attr} outside the host certification modules: the device "
                        "paths are float32; keep float64 on the host path")))
                if node.attr == "float32" and in_whitelist and base is not None and (
                        base in np_alias or base in th):
                    out.append(_viol(mod, node, self, (
                        "float32 cast inside the float64 certification path: the "
                        "residual/threshold arithmetic must stay float64")))
            if isinstance(node, ast.Call) and not in_whitelist:
                func = node.func
                if isinstance(func, ast.Attribute) and func.attr == "double" and not node.args:
                    out.append(_viol(mod, node, self, (
                        ".double() outside the host certification modules: the device paths "
                        "are float32")))
                for kw in node.keywords:
                    if kw.arg == "dtype" and isinstance(kw.value, ast.Constant) and kw.value.value in (
                            "float64", "double"):
                        out.append(_viol(mod, node, self, (
                            f'dtype="{kw.value.value}" outside the host certification modules')))
        return out


# --- R5: Python branches on CUDA tensor values ----------------------------------


class CudaValueBranchRule:
    """R5 — a Python ``if``/``while`` on a tensor's value in ``solvers/``,
    ``kernels/`` and ``parallel/``.

    The test's ``__bool__`` reads the value to the host: an implicit sync
    per branch that no guard window announces. Read it on purpose
    (``bool(...)``, ``float(...)``: a Python value, outside every window)
    or keep the choice on the device (``torch.where``). ``is None`` tests
    are exempt.
    """

    rule_id = "R5"
    name = "cuda-value-branch"
    description = "python branch on a tensor value in the hot paths"

    _SCOPES = ("solvers/", "kernels/", "parallel/")

    @staticmethod
    def _is_none_test(test: ast.AST) -> bool:
        if isinstance(test, ast.BoolOp):
            return all(CudaValueBranchRule._is_none_test(v) for v in test.values)
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            return CudaValueBranchRule._is_none_test(test.operand)
        if isinstance(test, ast.Compare):
            return all(isinstance(op, (ast.Is, ast.IsNot)) for op in test.ops)
        return False

    def check_module(self, mod: ModuleSource) -> List[Violation]:
        rel = mod.rel.replace("\\", "/")
        if _is_test_module(mod) or not any(s in rel for s in self._SCOPES):
            return []
        th = torch_aliases(mod.tree)
        out: List[Violation] = []
        for fn in walk(mod.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            names = tensor_names(fn, th)
            for node in walk(fn):
                if not isinstance(node, (ast.If, ast.While, ast.IfExp)):
                    continue
                if self._is_none_test(node.test) or not is_tensor_expr(node.test, names, th):
                    continue
                kind = "while" if isinstance(node, ast.While) else "if"
                out.append(_viol(mod, node, self, (
                    f"python {kind} on a tensor value in '{fn.name}': an implicit bool() sync; "
                    "read it on purpose outside the launch window or keep it on the device")))
        return out


# --- R7: thread discipline (a stdlib copy) ----------------------------------------


class ThreadDisciplineRule:
    """R7 — shared state written from a worker thread without a lock.

    The service's worker threads, the batcher's and the face loop's host
    overlap run pure functions over pre-partitioned buffers; hand-offs go
    through ``Future``/``Queue`` and shared mutable state takes a ``Lock``.
    Scoped to modules that import ``threading``/``concurrent.futures``: the
    worker roots (``<executor>.submit/map`` first arguments for names bound
    to a ``ThreadPoolExecutor``, ``Thread(target=...)``), their transitive
    same-module closure (bare names and ``self.method``), and writes to
    module state (``global`` rebinding, module containers/attributes) or
    ``self.attr`` outside a ``with <…lock…>:`` block.
    """

    rule_id = "R7"
    name = "thread-discipline"
    description = "unlocked shared-state write reachable from a worker thread"

    @staticmethod
    def _imports_threading(tree: ast.Module) -> bool:
        for node in walk(tree):
            if isinstance(node, ast.Import):
                if any(a.name.split(".")[0] in ("threading", "concurrent") for a in node.names):
                    return True
            if isinstance(node, ast.ImportFrom) and node.module:
                if node.module.split(".")[0] in ("threading", "concurrent"):
                    return True
        return False

    @staticmethod
    def _executor_names(tree: ast.Module) -> Set[str]:
        def is_executor_call(node: ast.AST) -> bool:
            if isinstance(node, ast.IfExp):
                return is_executor_call(node.body) or is_executor_call(node.orelse)
            return isinstance(node, ast.Call) and _last(node.func) == "ThreadPoolExecutor"

        names: Set[str] = set()
        for node in walk(tree):
            if isinstance(node, ast.Assign) and is_executor_call(node.value):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        names.add(t.id)
                    elif isinstance(t, ast.Attribute):
                        names.add(t.attr)
            if isinstance(node, ast.With):
                for item in node.items:
                    if is_executor_call(item.context_expr) and isinstance(item.optional_vars, ast.Name):
                        names.add(item.optional_vars.id)
        return names

    @staticmethod
    def _function_table(tree: ast.Module) -> Dict[str, List[ast.AST]]:
        table: Dict[str, List[ast.AST]] = {}
        for node in walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                table.setdefault(node.name, []).append(node)
        return table

    def _worker_roots(self, tree: ast.Module) -> List[ast.AST]:
        executors = self._executor_names(tree)
        table = self._function_table(tree)
        roots: List[ast.AST] = []

        def resolve(ref: ast.AST) -> None:
            if isinstance(ref, ast.Lambda):
                roots.append(ref)
            elif isinstance(ref, ast.Name):
                roots.extend(table.get(ref.id, []))
            elif isinstance(ref, ast.Attribute) and isinstance(ref.value, ast.Name) and ref.value.id == "self":
                roots.extend(table.get(ref.attr, []))

        for node in walk(tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            if isinstance(func, ast.Attribute) and func.attr in ("submit", "map"):
                recv = func.value
                recv_name = (recv.id if isinstance(recv, ast.Name)
                             else recv.attr if isinstance(recv, ast.Attribute) else None)
                if recv_name in executors and node.args:
                    resolve(node.args[0])
            if _last(func) == "Thread":
                for kw in node.keywords:
                    if kw.arg == "target":
                        resolve(kw.value)
        return roots

    @staticmethod
    def _under_lock(node: ast.AST, parents) -> bool:
        cur = parents.get(node)
        while cur is not None:
            if isinstance(cur, ast.With):
                for item in cur.items:
                    expr = item.context_expr
                    d = dotted(expr.func if isinstance(expr, ast.Call) else expr) or ""
                    if "lock" in d.rsplit(".", 1)[-1].lower():
                        return True
            cur = parents.get(cur)
        return False

    def check_module(self, mod: ModuleSource) -> List[Violation]:
        tree = mod.tree
        if not self._imports_threading(tree):
            return []
        roots = self._worker_roots(tree)
        if not roots:
            return []
        parents = parent_map(tree)
        table = self._function_table(tree)
        mod_names = module_names(tree)
        reachable: List[ast.AST] = []
        seen: Set[int] = set()
        work = list(roots)
        while work:
            fn = work.pop()
            if id(fn) in seen:
                continue
            seen.add(id(fn))
            reachable.append(fn)
            for node in walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                if isinstance(node.func, ast.Name):
                    targets = table.get(node.func.id, [])
                elif (isinstance(node.func, ast.Attribute) and isinstance(node.func.value, ast.Name)
                      and node.func.value.id == "self"):
                    targets = table.get(node.func.attr, [])
                else:
                    targets = []
                work.extend(t for t in targets if id(t) not in seen)

        out: List[Violation] = []
        flagged: Set[Tuple[int, int]] = set()

        def flag(node: ast.AST, what: str) -> None:
            out.append(_viol(mod, node, self, (
                f"{what} written from worker-thread code without a Lock/Queue mediating it: "
                "workers must stay pure over pre-partitioned buffers")))

        for fn in reachable:
            globals_here: Set[str] = set()
            for node in walk(fn):
                if isinstance(node, ast.Global):
                    globals_here.update(node.names)
            for node in walk(fn):
                if not isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                    continue
                key = (node.lineno, node.col_offset)
                if key in flagged or self._under_lock(node, parents):
                    continue
                targets = node.targets if isinstance(node, ast.Assign) else [node.target]
                for t in targets:
                    if isinstance(t, ast.Name) and t.id in globals_here:
                        flagged.add(key)
                        flag(node, f"module global '{t.id}'")
                    elif isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name):
                        if t.value.id == "self":
                            flagged.add(key)
                            flag(node, f"instance state 'self.{t.attr}'")
                        elif t.value.id in mod_names:
                            flagged.add(key)
                            flag(node, f"module state '{t.value.id}.{t.attr}'")
                    elif isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name) and (
                            t.value.id in mod_names):
                        flagged.add(key)
                        flag(node, f"module container '{t.value.id}[...]'")
        return out


# --- R8: registered cores are traced and costed ------------------------------------


def _dict_keys_of(modules: Sequence[ModuleSource], suffix: str, target: str) -> Optional[Set[str]]:
    """String keys of the module-level dict ``target`` of the module whose
    path ends with ``suffix``, or None when it is outside the scope."""
    for mod in modules:
        if not _rel(mod).endswith(suffix):
            continue
        for node in walk(mod.tree):
            if not isinstance(node, (ast.Assign, ast.AnnAssign)):
                continue
            targets = [node.target] if isinstance(node, ast.AnnAssign) else node.targets
            if not any(isinstance(t, ast.Name) and t.id == target for t in targets):
                continue
            if isinstance(node.value, ast.Dict):
                return {k.value for k in node.value.keys
                        if isinstance(k, ast.Constant) and isinstance(k.value, str)}
        return None
    return None


class CoreSpanRule:
    """R8 — every ``@register_ir_core`` names a ``dispatch_span`` its module
    calls, and that span has a cost function in ``obs/roofline.COSTS``
    (parsed statically when the roofline module is in the scope); or it
    gives a reasoned ``span_optout``. A core that can burn card time
    without showing in a request's trace, or without a bound in the
    roofline join, is the observability gap this closes.
    """

    rule_id = "R8"
    name = "core-span-coverage"
    description = "registered cores must declare a costed dispatch span or opt out"

    def check_package(self, modules: Sequence[ModuleSource], readme=None) -> List[Violation]:
        costs = _dict_keys_of(modules, "obs/roofline.py", "COSTS")
        out: List[Violation] = []
        for mod in modules:
            out.extend(self._check_module(mod, costs))
        return out

    def _check_module(self, mod: ModuleSource, costs: Optional[Set[str]]) -> List[Violation]:
        regs = [n for n in walk(mod.tree)
                if isinstance(n, ast.Call) and _last(n.func) == "register_ir_core"]
        if not regs:
            return []
        spans: Set[str] = set()
        for node in walk(mod.tree):
            if isinstance(node, ast.Call) and _last(node.func) == "dispatch_span" and node.args:
                spans.update(c.value for c in walk(node.args[0])
                             if isinstance(c, ast.Constant) and isinstance(c.value, str))
        out: List[Violation] = []
        for call in regs:
            core = call.args[0].value if call.args and isinstance(call.args[0], ast.Constant) else None
            kw = {k.arg: k.value for k in call.keywords}
            span_v, opt_v = kw.get("span"), kw.get("span_optout")
            if span_v is None and opt_v is None:
                out.append(_viol(mod, call, self, (
                    f"registered core {core!r} is not traced: declare span=\"<name>\" (and wrap "
                    "the entry point in dispatch_span) or span_optout=\"reason\"")))
            elif span_v is not None and opt_v is not None:
                out.append(_viol(mod, call, self, (
                    f"registered core {core!r} declares BOTH span= and span_optout=; pick one")))
            elif opt_v is not None:
                if not (isinstance(opt_v, ast.Constant) and isinstance(opt_v.value, str)
                        and opt_v.value.strip()):
                    out.append(_viol(mod, call, self, (
                        f"registered core {core!r}: span_optout needs a non-empty literal reason")))
            elif not (isinstance(span_v, ast.Constant) and isinstance(span_v.value, str)):
                out.append(_viol(mod, call, self, f"registered core {core!r}: span= must be a string literal"))
            elif span_v.value not in spans:
                out.append(_viol(mod, call, self, (
                    f"registered core {core!r} declares span='{span_v.value}' but no "
                    f"dispatch_span('{span_v.value}', …) call exists in this module")))
            elif costs is not None and span_v.value not in costs:
                out.append(_viol(mod, call, self, (
                    f"registered core {core!r}: span '{span_v.value}' has no cost function in "
                    "obs/roofline.COSTS, so the roofline join misses it")))
        return out


# --- R9: fault sites are catalogued ------------------------------------------------


class FaultSiteRule:
    """R9 — every ``inject.site("<name>")`` / ``inject.raise_if("<name>")``
    names a string literal registered in ``robust/inject.FAULT_SITES``
    (parsed statically when in the scope) and documented, in backticks, in
    the README section of the package."""

    rule_id = "R9"
    name = "fault-site-catalogue"
    description = "inject.site literals must be registered and README-documented"

    _CALL_NAMES = ("site", "raise_if")

    def check_package(self, modules: Sequence[ModuleSource], readme=None) -> List[Violation]:
        from citizensassemblies_tpu_torch.lint.config_rule import _find_readme, readme_section

        registry = None
        inject_mod = None
        for mod in modules:
            if mod.path.name == "inject.py" and "robust" in str(mod.path):
                inject_mod = mod
                registry = _dict_keys_of([mod], "inject.py", "FAULT_SITES")
        readme_path = _find_readme(modules, readme)
        readme_text = readme_path.read_text(encoding="utf-8") if readme_path is not None else ""
        if inject_mod is not None:
            readme_text = readme_section(readme_text, inject_mod.path.resolve().parents[1].name)
        out: List[Violation] = []
        for mod in modules:
            if mod is inject_mod:
                continue
            for node in walk(mod.tree):
                if not isinstance(node, ast.Call):
                    continue
                parts = (dotted(node.func) or "").rsplit(".", 2)
                if parts[-1] not in self._CALL_NAMES or len(parts) < 2 or parts[-2] != "inject":
                    continue
                if not node.args or not (isinstance(node.args[0], ast.Constant)
                                         and isinstance(node.args[0].value, str)):
                    out.append(_viol(mod, node, self, (
                        f"{parts[-1]}() needs a string LITERAL site name: a computed site cannot "
                        "be audited against the catalogue or replayed from a chaos spec")))
                    continue
                site_name = node.args[0].value
                if registry is not None and site_name not in registry:
                    out.append(_viol(mod, node, self, (
                        f"fault site '{site_name}' is not registered in robust/inject.FAULT_SITES")))
                    continue
                if readme_text and f"`{site_name}`" not in readme_text:
                    out.append(_viol(mod, node, self, (
                        f"fault site '{site_name}' is missing from the README's fault-injection "
                        "catalogue (name in backticks)")))
        return out


# --- R10: mesh axis literals and per-call meshes -------------------------------------


class MeshHygieneRule:
    """R10 — mesh axis names are spelled only in ``dist/runtime.py`` and
    process groups / device meshes are built once per mesh key.

    The topology module defines ``AXIS_CHAINS``/``AXIS_AGENTS`` (parsed
    statically; fallback: the canonical pair): a ``"chains"`` or
    ``"agents"`` literal passed to any call elsewhere keeps working until
    the axis is renamed, then fails on the biggest world first. A
    ``DeviceMesh(``, ``init_device_mesh(`` or ``new_group(`` inside a
    function with no memo (a ``global``, a store into a module-level
    container) and that does not return it builds a communicator per
    call.
    """

    rule_id = "R10"
    name = "mesh-hygiene"
    description = "axis-name literals / process groups built per call"

    _TOPOLOGY_SUFFIX = "dist/runtime.py"
    # graftlint: disable=R10 -- the rule's own fallback when dist/runtime.py is outside the scope
    _FALLBACK_AXES = frozenset({"chains", "agents"})
    _MESH_BUILDERS = frozenset({"DeviceMesh", "init_device_mesh", "new_group"})

    @classmethod
    def _is_topology(cls, mod: ModuleSource) -> bool:
        return _rel(mod).endswith(cls._TOPOLOGY_SUFFIX)

    @classmethod
    def axis_names(cls, modules: Sequence[ModuleSource]) -> Set[str]:
        for mod in modules:
            if not cls._is_topology(mod):
                continue
            found: Set[str] = set()
            for node in mod.tree.body:
                if isinstance(node, ast.Assign) and isinstance(node.value, ast.Constant) and isinstance(
                        node.value.value, str):
                    for t in node.targets:
                        if isinstance(t, ast.Name) and t.id.startswith("AXIS_"):
                            found.add(node.value.value)
            if found:
                return found
        return set(cls._FALLBACK_AXES)

    def check_package(self, modules: Sequence[ModuleSource], readme=None) -> List[Violation]:
        axes = self.axis_names(modules)
        out: List[Violation] = []
        for mod in modules:
            if self._is_topology(mod) or _is_test_module(mod):
                continue
            parents = parent_map(mod.tree)
            mod_names = module_names(mod.tree)
            for node in walk(mod.tree):
                if not isinstance(node, ast.Call):
                    continue
                for arg in list(node.args) + [kw.value for kw in node.keywords]:
                    elts = arg.elts if isinstance(arg, (ast.Tuple, ast.List, ast.Set)) else [arg]
                    for c in elts:
                        if isinstance(c, ast.Constant) and isinstance(c.value, str) and c.value in axes:
                            out.append(_viol(mod, c, self, (
                                f"hardcoded mesh axis name '{c.value}': import the axis constant "
                                "from dist/runtime.py instead of spelling the literal")))
                last = _last(node.func)
                if last not in self._MESH_BUILDERS:
                    continue
                fn = enclosing(node, parents, (ast.FunctionDef, ast.AsyncFunctionDef))
                if fn is None or _has_memo_pattern(fn, mod_names) or _is_factory(fn, node, parents):
                    continue
                out.append(_viol(mod, node, self, (
                    f"{last}( per call of '{fn.name}' with no memo: build each process group or "
                    "mesh once per mesh key, in a module-level cache")))
        return out


# --- R11: metric names come from the catalogue ----------------------------------------


class MetricHygieneRule:
    """R11 — every metric name literal is registered in ``obs/catalog.py``
    (``METRIC_SERIES`` exactly, or a ``METRIC_PREFIXES`` family), per
    emission call site (``log.count``/``gauge``/``timer``, registry
    ``counter``/``gauge``/``timer``/``histogram``). A computed name, or an
    f-string whose leading literal no prefix covers, is flagged. The
    metrics plumbing, the catalogue and test modules are exempt."""

    rule_id = "R11"
    name = "metric-hygiene"
    description = "metric name literals must be registered in obs/catalog.py"

    _METHODS = ("gauge", "timer", "counter", "histogram")
    _COUNT_TAILS = ("log", "metrics")
    _EXEMPT = ("obs/catalog.py", "obs/metrics.py", "utils/logging.py")

    @staticmethod
    def _catalogue(modules: Sequence[ModuleSource]) -> Optional[Tuple[Set[str], Set[str]]]:
        for mod in modules:
            if mod.path.name != "catalog.py" or "obs" not in str(mod.path):
                continue
            series: Set[str] = set()
            prefixes: Set[str] = set()
            for node in walk(mod.tree):
                if not isinstance(node, (ast.Assign, ast.AnnAssign)):
                    continue
                targets = [node.target] if isinstance(node, ast.AnnAssign) else node.targets
                names = {t.id for t in targets if isinstance(t, ast.Name)}
                if "METRIC_SERIES" in names and isinstance(node.value, ast.Dict):
                    series = {k.value for k in node.value.keys
                              if isinstance(k, ast.Constant) and isinstance(k.value, str)}
                elif "METRIC_PREFIXES" in names and node.value is not None:
                    prefixes = {c.value for c in walk(node.value)
                                if isinstance(c, ast.Constant) and isinstance(c.value, str)}
            return series, prefixes
        return None

    @staticmethod
    def _name_literals(node: ast.AST) -> Optional[List[str]]:
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            return [node.value]
        if isinstance(node, ast.IfExp):
            body = MetricHygieneRule._name_literals(node.body)
            orelse = MetricHygieneRule._name_literals(node.orelse)
            if body is None or orelse is None:
                return None
            return body + orelse
        return None

    def check_package(self, modules: Sequence[ModuleSource], readme=None) -> List[Violation]:
        catalogue = self._catalogue(modules)
        if catalogue is None:
            return []
        series, prefixes = catalogue
        out: List[Violation] = []
        for mod in modules:
            if any(_rel(mod).endswith(e) for e in self._EXEMPT) or _is_test_module(mod):
                continue
            for node in walk(mod.tree):
                if not isinstance(node, ast.Call) or not isinstance(node.func, ast.Attribute):
                    continue
                method = node.func.attr
                receiver = dotted(node.func.value)
                tail = receiver.rsplit(".", 1)[-1] if receiver else ""
                if method == "count":
                    if not (tail in self._COUNT_TAILS or tail.endswith("_log") or tail.endswith("_metrics")):
                        continue
                elif method not in self._METHODS:
                    continue
                arg = node.args[0] if node.args else next(
                    (kw.value for kw in node.keywords if kw.arg == "name"), None)
                if arg is None:
                    continue
                if isinstance(arg, ast.JoinedStr):
                    lead = (arg.values[0].value if arg.values and isinstance(arg.values[0], ast.Constant)
                            and isinstance(arg.values[0].value, str) else "")
                    if not any(lead.startswith(p) for p in prefixes):
                        out.append(_viol(mod, node, self, (
                            f"f-string metric name leads with '{lead}', which no METRIC_PREFIXES "
                            "family covers")))
                    continue
                literals = self._name_literals(arg)
                if literals is None:
                    out.append(_viol(mod, node, self, (
                        f"{method}() metric name is computed: a name the catalogue cannot see can "
                        "silently mint a new series")))
                    continue
                for lit in literals:
                    if lit not in series and not any(lit.startswith(p) for p in prefixes):
                        out.append(_viol(mod, node, self, (
                            f"metric name '{lit}' is not registered in obs/catalog.py "
                            "METRIC_SERIES (or a METRIC_PREFIXES family)")))
        return out


# --- R12: placements are declared in dist/partition.py -----------------------------------


class PlacementHygieneRule:
    """R12 — ``Shard(``, ``Replicate(`` and ``distribute_tensor(`` appear
    only in ``dist/partition.py`` (its ``ROLE_BUILDERS``).

    The SPMD pass checks each operand's placement against its declared
    role; a placement spelled inline at a call site is invisible to it, and
    two sites hand-rolling "the" layout drift apart. Call a role (or add
    one) instead. Test modules are exempt.
    """

    rule_id = "R12"
    name = "placement-hygiene"
    description = "inline Shard/Replicate/distribute_tensor outside dist/partition.py"

    _PARTITION_SUFFIX = "dist/partition.py"
    _NAMES = frozenset({"Shard", "Replicate", "distribute_tensor"})

    def check_module(self, mod: ModuleSource) -> List[Violation]:
        if _rel(mod).endswith(self._PARTITION_SUFFIX) or _is_test_module(mod):
            return []
        out: List[Violation] = []
        for node in walk(mod.tree):
            if isinstance(node, ast.Call) and _last(node.func) in self._NAMES:
                out.append(_viol(mod, node, self, (
                    f"inline {_last(node.func)}( outside dist/partition.py: declare the layout as a "
                    "ROLE_BUILDERS role so the SPMD pass can check it")))
        return out


# --- R13: 16-bit dtype literals live in utils/precision.py --------------------------------


class DtypeLiteralHygieneRule:
    """R13 — precision policy lives in ``utils/precision.py``.

    The committed plan decides what is stored at bf16 and
    ``utils/precision.demote_operator`` applies it: ``torch.bfloat16``,
    ``torch.float16`` or a ``"bfloat16"``/``"bf16"`` dtype string spelled
    anywhere else is an uncertified demotion the plan never sees. In
    ``solvers/`` and ``kernels/`` an operand-derived ``dtype=<x>.dtype``
    (or a policy assignment ``d = x.dtype``) not wrapped in
    ``iterate_dtype(...)`` lets iterates follow a demoted operand down to
    bf16, where the KKT tolerance is out of reach. Test modules and the
    R4 certification modules are exempt.
    """

    rule_id = "R13"
    name = "dtype-literal-hygiene"
    description = "16-bit dtype literals outside utils/precision.py / un-floored operand dtype="

    _POLICY_SUFFIX = "utils/precision.py"
    # graftlint: disable=R13 -- the attribute names this rule searches for
    _HALF_ATTRS = frozenset({"bfloat16", "float16", "half"})
    # graftlint: disable=R13 -- the literals this rule searches for
    _HALF_STRS = frozenset({"bfloat16", "float16", "bf16"})

    def check_module(self, mod: ModuleSource) -> List[Violation]:
        rel = mod.rel.replace("\\", "/")
        if (_rel(mod).endswith(self._POLICY_SUFFIX) or _is_test_module(mod)
                or any(rel.endswith(w) for w in DtypeDisciplineRule._F64_WHITELIST)):
            return []
        hot = "solvers/" in rel or "kernels/" in rel
        th = torch_aliases(mod.tree)
        np_alias = numpy_aliases(mod.tree)
        out: List[Violation] = []
        for node in walk(mod.tree):
            if isinstance(node, ast.Attribute) and node.attr in self._HALF_ATTRS:
                base = dotted(node.value)
                if base is not None and (base in th or base in np_alias) and node.attr != "half":
                    out.append(_viol(mod, node, self, (
                        f"raw {base}.{node.attr} literal: only utils/precision.py spells the "
                        "demotion target (demote_operator applies the certified plan)")))
            if isinstance(node, ast.Constant) and isinstance(node.value, str) and node.value in self._HALF_STRS:
                out.append(_viol(mod, node, self, (
                    f'"{node.value}" literal: only utils/precision.py spells the demotion target')))
            if not hot:
                continue
            if isinstance(node, ast.Call):
                for kw in node.keywords:
                    if kw.arg == "dtype" and isinstance(kw.value, ast.Attribute) and kw.value.attr == "dtype":
                        out.append(_viol(mod, node, self, (
                            f"operand-derived dtype={dotted(kw.value)} in a hot path: once the plan "
                            "demotes that operand, iterates built from it inherit bf16; wrap in "
                            "utils/precision.iterate_dtype(...)")))
            if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Attribute)
                    and node.value.attr == "dtype"):
                tgt = node.targets[0]
                tname = tgt.id if isinstance(tgt, ast.Name) else "?"
                out.append(_viol(mod, node, self, (
                    f"dtype policy assignment {tname} = {dotted(node.value)} is un-floored; wrap "
                    "in utils/precision.iterate_dtype(...)")))
        return out
