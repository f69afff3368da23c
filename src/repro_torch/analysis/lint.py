"""AST lint of the port's own coding contracts (cf. ``repro.analysis.lint``).

It walks the port's tree (``src/repro_torch``, ``examples/*_torch.py``,
``chip_smoke.py``, ``tools/``) with the JAX module's API and rule ids, the
call sets being torch's:

* **R001 import-time device work** — no module-scope call that touches
  CUDA or does tensor work: no ``torch.cuda.*`` call but ``is_available``,
  no tensor factory (``torch.zeros``, ``torch.tensor``, ...), no
  ``.cuda()`` or ``.to(...)``, no ``torch.Generator(device=...)``, no
  ``torch.manual_seed``, and no ``kernels.build`` ``build`` or
  ``library``.  The kernels are built at first use and the CPU tests
  import every module; an import that builds them, or that initialises
  CUDA, is the bug this rule catches.  (Class bodies run at import too;
  function bodies do not.)
* **R003 bad registry spec** — spec-string literals handed to the port's
  registries (``get_attack`` / ``get_wire_attack`` / ``get_adaptive`` /
  ``get_codec`` and ``GroupConfig.from_spec``, and ``attack=`` /
  ``codec=`` / ``hier=`` keyword literals anywhere) are bound against the
  port's real registries at lint time, so a misspelt parameter fails here
  and not at step time.
* **R004 state integer index** — ``TrainerState`` is accessed by field
  name, never ``state[0]``: slots move when the dataclass grows.
* **R006 async blocking collective** — no blocking ``torch.distributed``
  collective (``all_reduce``, ``all_gather*``, ``broadcast``,
  ``barrier``, ``reduce_scatter*``, ``all_to_all*``, ``send`` /
  ``recv``, and ``core/api.py``'s ``_all_gather``) under
  ``repro_torch/serve/`` or in a function whose name mentions ``async``:
  the bounded-staleness service never waits on workers.
* **R007 debug I/O in a step** — no ``print``, ``sys.stdout`` /
  ``sys.stderr`` write or ``logging`` call inside a function named
  ``step`` or ``*_step``: each is a host round trip a step.
  ``repro_torch/obs/`` (the sanctioned channel) is exempt by path.

Two JAX rules have no counterpart:

* **R002** (a Python branch on a tracer): in eager mode such a branch is
  correct; what it costs is a host synchronisation, which
  ``chip_smoke.py``'s O2 phase measures with
  ``torch.cuda.set_sync_debug_mode``;
* **R005** (jit static arguments): the port compiles no graph (no
  ``torch.compile``), so there is no trace for a flag to go stale in.

``lint_source`` lints one source string; ``lint_paths`` walks files and
directories.  Both are pure AST passes: linted code is never imported
(R003 imports the port's registries, not the linted file).
"""
from __future__ import annotations

import ast
import dataclasses
import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

RULE_IDS = ("R001", "R003", "R004", "R006", "R007")

#: tensor factories: a call at module scope allocates a tensor at import
_TENSOR_FACTORIES = frozenset({
    "tensor", "as_tensor", "from_numpy", "zeros", "ones", "empty", "full",
    "rand", "randn", "randint", "randperm", "arange", "linspace", "logspace",
    "eye", "zeros_like", "ones_like", "empty_like", "full_like",
    "rand_like", "randn_like", "randint_like", "normal", "empty_strided",
    "manual_seed",
})
#: the one torch.cuda call an import may make
_CUDA_QUERIES = frozenset({"torch.cuda.is_available"})
#: ``kernels.build``'s functions that run nvcc or load a library
_BUILD_CALLS = frozenset({"build", "library"})
_BUILD_MODULE = "repro_torch.kernels.build"
#: registry getters whose first positional string literal is a spec
_SPEC_GETTERS = {"get_attack": "attack", "get_wire_attack": "attack",
                 "get_adaptive": "attack", "get_codec": "codec"}
#: keyword names carrying spec literals anywhere in the tree
_SPEC_KWARGS = {"attack": "attack", "codec": "codec", "hier": "hier"}
_STATE_NAMES = frozenset({"state", "tstate", "trainer_state"})


@dataclasses.dataclass(frozen=True)
class Violation:
    rule: str
    path: str
    line: int
    msg: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.msg}"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def _dotted(node: ast.AST) -> Optional[str]:
    """'torch.cuda.synchronize' for an Attribute/Name chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return ".".join(reversed(parts))


def _attr(node: ast.AST) -> Optional[str]:
    """The called attribute of ``<anything>.name(...)``, else None."""
    return node.attr if isinstance(node, ast.Attribute) else None


def _walk_pruned(node: ast.AST, prune: Tuple[type, ...]) -> Iterable[ast.AST]:
    """ast.walk that does not descend into ``prune`` node types."""
    stack: List[ast.AST] = list(ast.iter_child_nodes(node))
    while stack:
        child = stack.pop()
        yield child
        if not isinstance(child, prune):
            stack.extend(ast.iter_child_nodes(child))


_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


def _build_aliases(tree: ast.Module) -> Dict[str, str]:
    """Local names bound to ``kernels.build`` or its build / library:
    {name: "module"} or {name: "build" | "library"}."""
    out: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                local = a.asname or a.name
                if node.module.endswith("kernels") and a.name == "build":
                    out[local] = "module"
                elif node.module.endswith("kernels.build") \
                        and a.name in _BUILD_CALLS:
                    out[local] = a.name
        elif isinstance(node, ast.Import):
            for a in node.names:
                if a.name == _BUILD_MODULE:
                    out[a.asname or a.name] = "module"
    return out


# ------------------------------------------------------------------ R001
def _device_work(node: ast.Call, aliases: Dict[str, str]) -> Optional[str]:
    """What makes a module-scope call device or tensor work, or None."""
    name = _dotted(node.func)
    attr = _attr(node.func)
    if name is not None:
        if name.startswith("torch.cuda.") and name not in _CUDA_QUERIES:
            return name
        head, _, tail = name.rpartition(".")
        if head == "torch" and tail in _TENSOR_FACTORIES:
            return name
        if name == "torch.Generator" and (node.args or any(
                kw.arg == "device" for kw in node.keywords)):
            return "torch.Generator(device=...)"
        if aliases.get(name) in _BUILD_CALLS or (
                aliases.get(head) == "module" and tail in _BUILD_CALLS) or (
                head.endswith("kernels.build") and tail in _BUILD_CALLS):
            return name
    if attr in ("cuda", "to"):
        return f".{attr}()"
    return None


def _rule_import_time(tree: ast.Module, path: str) -> List[Violation]:
    out = []
    aliases = _build_aliases(tree)

    def scan_body(body: Sequence[ast.stmt]) -> None:
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue                   # bodies run at call time
            if isinstance(stmt, ast.ClassDef):
                scan_body(stmt.body)       # class bodies run at import
                continue
            for node in _walk_pruned(stmt, _FUNC_NODES):
                if not isinstance(node, ast.Call):
                    continue
                what = _device_work(node, aliases)
                if what is not None:
                    out.append(Violation(
                        "R001", path, node.lineno,
                        f"device or tensor work at module import: {what} "
                        "— move it into a function (an import builds no "
                        "kernel and touches no card)"))

    scan_body(tree.body)
    return out


# ------------------------------------------------------------------ R003
def _first_error(calls) -> Optional[str]:
    """None if one of ``calls`` returns, else the first one's error."""
    errors = []
    for call in calls:
        try:
            call()
            return None
        except (ValueError, TypeError, KeyError) as e:
            errors.append(str(e))
    return errors[0]


def _check_spec(kind: str, spec: str) -> Optional[str]:
    """Bind one spec literal against the port's registries: an error
    message, or None when the spec is valid."""
    if kind == "attack":
        if spec in ("", "none"):
            return None
        from repro_torch.core import attacks as ATK
        return _first_error([lambda: ATK.get_attack(spec),
                             lambda: ATK.get_wire_attack(spec),
                             lambda: ATK.get_adaptive(spec)])
    if kind == "codec":
        if spec in ("", "none"):
            return None
        from repro_torch.comm import codecs as CC
        return _first_error([lambda: CC.get_codec(spec)])
    from repro_torch.hier import GroupConfig
    return _first_error([lambda: GroupConfig.from_spec(spec)])


def _rule_registry_specs(tree: ast.Module, path: str) -> List[Violation]:
    out = []

    def check(kind: str, spec: str, lineno: int) -> None:
        err = _check_spec(kind, spec)
        if err is not None:
            out.append(Violation(
                "R003", path, lineno,
                f"{kind} spec {spec!r} does not bind against the port's "
                f"registry: {err}"))

    def literal(node: ast.AST) -> Optional[str]:
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            return node.value
        return None

    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        tail = (_dotted(node.func) or _attr(node.func) or "").rsplit(
            ".", 1)[-1]
        first = literal(node.args[0]) if node.args else None
        if tail in _SPEC_GETTERS and first is not None:
            check(_SPEC_GETTERS[tail], first, node.lineno)
        if tail == "from_spec" and first is not None and "g=" in first:
            check("hier", first, node.lineno)
        for kw in node.keywords:
            value = literal(kw.value)
            if kw.arg in _SPEC_KWARGS and value is not None:
                check(_SPEC_KWARGS[kw.arg], value, kw.value.lineno)
    return out


# ------------------------------------------------------------------ R004
def _rule_state_index(tree: ast.Module, path: str) -> List[Violation]:
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Subscript):
            continue
        base = node.value
        name = base.id if isinstance(base, ast.Name) else (
            base.attr if isinstance(base, ast.Attribute) else None)
        if name not in _STATE_NAMES:
            continue
        idx = node.slice
        if isinstance(idx, ast.UnaryOp) and isinstance(idx.op, ast.USub):
            idx = idx.operand
        if isinstance(idx, ast.Constant) and isinstance(idx.value, int) \
                and not isinstance(idx.value, bool):
            out.append(Violation(
                "R004", path, node.lineno,
                f"TrainerState indexed positionally ({name}[...]) — "
                "access fields by name; slots move when the dataclass "
                "grows"))
    return out


# ------------------------------------------------------------------ R006
#: torch.distributed's blocking collectives (each a barrier over a group)
_COLLECTIVES = frozenset({
    "all_reduce", "all_gather", "all_gather_into_tensor",
    "all_gather_object", "all_gather_single", "broadcast",
    "broadcast_object_list", "barrier", "reduce", "reduce_scatter",
    "reduce_scatter_tensor", "all_to_all", "all_to_all_single", "send",
    "recv", "gather", "scatter",
})
_DIST_MODULES = ("dist", "torch.distributed", "c10d")
#: the port's own gather helper (``core/api.py``)
_PORT_COLLECTIVES = frozenset({"_all_gather"})
_SERVE_PATH_MARKER = "repro_torch/serve/"


def _collective(node: ast.Call) -> Optional[str]:
    name = _dotted(node.func)
    if name is None:
        return None
    head, _, tail = name.rpartition(".")
    if (head in _DIST_MODULES and tail in _COLLECTIVES) \
            or tail in _PORT_COLLECTIVES:
        return name
    return None


def _rule_async_collective(tree: ast.Module, path: str) -> List[Violation]:
    out = []

    def scan(node: ast.AST, where: str) -> None:
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call) and _collective(sub):
                out.append(Violation(
                    "R006", path, sub.lineno,
                    f"blocking collective {_collective(sub)}() inside "
                    f"{where} — the async service never waits on the "
                    "workers; route cross-worker data through the "
                    "staleness buffer's admission"))

    if _SERVE_PATH_MARKER in path.replace("\\", "/"):
        scan(tree, "repro_torch/serve (the async service package)")
        return out
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and "async" in node.name.lower():
            scan(node, f"async service function {node.name}()")
    return out


# ------------------------------------------------------------------ R007
_DEBUG_IO_CALLS = frozenset({"print", "sys.stdout.write", "sys.stderr.write",
                             "sys.stdout.flush", "sys.stderr.flush"})
_OBS_PATH_MARKER = "repro_torch/obs/"


def _debug_io(node: ast.Call) -> Optional[str]:
    name = _dotted(node.func) or ""
    if name in _DEBUG_IO_CALLS or name.startswith("logging."):
        return name
    return None


def _rule_debug_io(tree: ast.Module, path: str) -> List[Violation]:
    out = []
    if _OBS_PATH_MARKER in path.replace("\\", "/"):
        return out
    seen = set()
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                or not (node.name == "step" or node.name.endswith("_step")):
            continue
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Call):
                continue
            name = _debug_io(sub)
            if name is not None and (sub.lineno, name) not in seen:
                seen.add((sub.lineno, name))
                out.append(Violation(
                    "R007", path, sub.lineno,
                    f"host debug I/O {name}() inside step function "
                    f"{node.name}() — a host round trip a step; record "
                    "into the repro_torch.obs registry or span ring"))
    return out


#: rule id -> one-line description (R000 is the parse-failure sentinel)
RULES = {
    "R000": "file must parse",
    "R001": "no CUDA, tensor or kernel-build work at module import",
    "R003": "registry spec strings must resolve against the port's "
            "registries",
    "R004": "TrainerState is accessed by field name, never by index",
    "R006": "no blocking collectives inside the async service loop",
    "R007": "no host debug I/O inside step functions (use "
            "repro_torch.obs)",
}


# ------------------------------------------------------------------ the pass
def lint_source(src: str, path: str = "<string>") -> List[Violation]:
    """Lint one source string; returns violations sorted by position."""
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:
        return [Violation("R000", path, e.lineno or 0,
                          f"syntax error: {e.msg}")]
    out: List[Violation] = []
    out += _rule_import_time(tree, path)
    out += _rule_registry_specs(tree, path)
    out += _rule_state_index(tree, path)
    out += _rule_async_collective(tree, path)
    out += _rule_debug_io(tree, path)
    return sorted(out, key=lambda v: (v.path, v.line, v.rule))


def lint_paths(paths: Iterable[str]) -> List[Violation]:
    """Lint files and (recursively) directories of ``*.py`` files."""
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, _dirs, names in os.walk(p):
                files += [os.path.join(root, n) for n in sorted(names)
                          if n.endswith(".py")]
        else:
            files.append(p)
    out: List[Violation] = []
    for fp in files:
        with open(fp, encoding="utf-8") as fh:
            out += lint_source(fh.read(), fp)
    return out


def port_paths(root: str = ".") -> List[str]:
    """The port's tree under ``root``: ``src/repro_torch``,
    ``examples/*_torch.py``, ``chip_smoke.py`` and ``tools/``, those that
    exist."""
    out = [os.path.join(root, "src", "repro_torch")]
    ex = os.path.join(root, "examples")
    if os.path.isdir(ex):
        out += [os.path.join(ex, n) for n in sorted(os.listdir(ex))
                if n.endswith("_torch.py")]
    out += [os.path.join(root, "chip_smoke.py"), os.path.join(root, "tools")]
    return [p for p in out if os.path.exists(p)]
