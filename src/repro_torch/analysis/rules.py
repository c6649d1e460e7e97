"""Layer 3: the port's repo rules, proved from source by AST lint
(``repro.analysis.rules`` counterpart).

* **oracle-purity** — ``repro_torch.oracle`` imports the stdlib, numpy and
  itself only: the golden model must not share code with what it checks.
* **port-isolation** — no module of ``src/repro_torch`` and not
  ``chip_smoke.py`` imports ``jax``, ``jaxlib`` or ``repro``
  (``tests/test_torch_isolation.py`` holds the same, test by test; this
  is the CLI's copy).
* **static-geometry** — in device code of ``core/`` and ``faults/``, row to
  region or slot indexing divides by the *active* geometry
  (``active_geometry``, ``TunableParams.*_active``), never ``//`` or
  ``%`` by an allocated field (``p.region_size``, ``p.n_regions``,
  ``p.n_slots`` or a name bound to one): under a padded allocation the
  allocated stride is the storage layout (JAX ``rules.py:66``).
* **narrow-counter** — the wide statistics (``stall_cycles``,
  ``read/write_latency_sum``) are native int64 in the port; no code of
  the cycle surface builds or accumulates them through a narrower dtype
  (``.int()``, ``torch.int32``, ``dtype=`` of a narrower type, ...).
* **host-sync** (the counterpart of tracer-branch) — every function of
  the cycle surface is classified as device code (runs every cycle or
  serving step) or host code (set-up, summaries), as JAX's TRACED/HOST
  lists are; an unlisted function is itself a finding. Inside device code
  a host read is a finding unless a waiver names why it exists: ``.item()``,
  ``.tolist()``, ``.cpu()``, ``.numpy()``, ``nonzero`` (its size is read
  back), ``bool()``/``int()``/``float()`` of a tensor, and
  ``if``/``while``/conditional expressions on a tensor.
  What is static is decided by a small grammar: constants, the params
  and configs (``p``, ``cfg``, ``self.p``, ...), tensor metadata
  (``.shape``, ``.dtype``, ``.dim()``, ``.numel()``), ``x is None``,
  parameters annotated with host types (``int``, ``MemParams``, ...),
  and names bound to any of these or to a host read's result. The waived
  set is the inventory of the cycle's host reads, which CUDA-graph
  capture will start from.
* **no-fallback** (the counterpart of kernel-interpret) — a ``try`` whose
  body launches a ``*_cuda`` entry and whose handler reaches a plain
  version, or a ``torch.cuda.is_available()`` test that picks the CPU:
  either would run the plain PyTorch version on the card's path unasked.
  The scan covers the whole package (the kernels, their dispatchers and
  every entry point).

A finding is waived where the code is right and the rule conservative:
``# analysis: <rule-id> <reason>`` on the offending line or the line
above it (above a statement, it covers every line of the statement). A
waiver without a reason is a finding of its own (``waiver-reason``).

JAX's bench-manifest rule has no counterpart yet: the port has no
benchmarks (ROADMAP queue 1 item 3); it comes with them.
"""
from __future__ import annotations

import ast
import os
import re
from typing import Dict, Iterable, List, Optional, Set

from repro_torch.analysis.base import (PORT_ROOT, REPO_ROOT, Finding,
                                       python_files, rel)

# --------------------------------------------------------------- rule scope
ORACLE_SCOPE = "src/repro_torch/oracle"
ISOLATION_EXTRA = ("chip_smoke.py",)
# the cycle surface: everything one simulated cycle or one serving step
# runs, and their set-up
DEVICE_SCOPE = ("src/repro_torch/core", "src/repro_torch/faults",
                "src/repro_torch/obs/planes.py",
                "src/repro_torch/obs/serve.py",
                "src/repro_torch/runtime/kvbank.py")
GEOMETRY_SCOPE = ("src/repro_torch/core/", "src/repro_torch/faults/")

ORACLE_ALLOWED_ROOTS = {
    "numpy", "dataclasses", "itertools", "typing", "collections", "math",
    "functools", "enum", "__future__", "repro_torch.oracle",
}
BANNED_ROOTS = ("jax", "jaxlib", "repro")

GEOM_FIELDS = {"region_size", "n_regions", "n_slots"}
WIDE_FIELDS = {"stall_cycles", "read_latency_sum", "write_latency_sum"}
NARROW_DTYPES = {"int32", "int16", "int8", "uint8", "uint16", "uint32",
                 "float16", "bfloat16", "float32", "half", "float", "int",
                 "short"}
NARROW_METHODS = {"int", "short", "char", "byte", "half", "float",
                  "bfloat16"}

# names whose attributes are host values by contract: params, configs and
# scheme tables are python/numpy containers (``t``/``self.t`` are the
# device tables: not static)
STATIC_ROOTS = {"p", "params", "cfg", "kvcfg", "tables", "plan"}
SELF_STATIC = {"p", "n_cores", "device", "tables", "tunables"}
# attributes that are host metadata on any tensor
STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "type"}
STATIC_METHODS = {"dim", "numel", "size", "is_floating_point",
                  "element_size", "is_contiguous"}
STATIC_CALLS = {"min", "max", "round", "tuple", "sorted", "range",
                "getattr", "all", "any", "sum", "abs", "list", "zip",
                "enumerate", "str"}
# calls whose result is a host value whatever their arguments: type
# checks, sizes, the casts (a cast of a tensor is itself flagged), and
# host predicates that read only metadata
ALWAYS_STATIC_CALLS = {"isinstance", "hasattr", "callable", "type", "len",
                       "int", "float", "bool", "pool_coded"}
# annotation names that declare a host value
STATIC_TYPES = {"int", "bool", "float", "str", "MemParams", "KVBankConfig",
                "CodeTables", "CodeScheme", "FaultPlan", "ModelConfig",
                "Optional", "Tuple", "Sequence", "List", "None", "torch",
                "dtype", "device"}
# reads to the host: a copy, or a result whose size the host must learn
HOST_READS = {"item", "tolist", "cpu", "numpy", "nonzero"}

# ------------------------------------------------- function classification
# every function of DEVICE_SCOPE appears in exactly one of these maps
# ("func" or "Class.method"; "Class.*" and "*" are wildcards)
DEVICE_FUNCTIONS: Dict[str, Set[str]] = {
    "src/repro_torch/core/controller.py": {
        "col", "point_offsets", "add_offset", "_trip_major", "_walk_bounds",
        "_plan_counts", "build_read_pattern", "build_write_pattern",
        "build_read_patterns", "build_write_patterns", "_rc_push"},
    "src/repro_torch/core/recoding.py": {"recode_step", "recode_steps"},
    "src/repro_torch/core/dynamic.py": {"dynamic_step", "_ints",
                                        "_to_device"},
    "src/repro_torch/core/state.py": {"active_geometry", "_map",
                                      "batch_of_one", "point_of"},
    "src/repro_torch/core/system.py": {
        "quiescent", "_pick", "_set_flat", "_add_ones", "run_chunk_shards",
        "CodedMemorySystem._idle_ports", "CodedMemorySystem._arbiter",
        "CodedMemorySystem._read_values", "CodedMemorySystem._commit_writes",
        "CodedMemorySystem._do_reads", "CodedMemorySystem._do_writes",
        "CodedMemorySystem._branch_planes", "CodedMemorySystem.cycle_fn",
        "CodedMemorySystem.cycle_batch", "CodedMemorySystem._run",
        "CodedMemorySystem.run_chunk", "CodedMemorySystem.run_chunk_batch"},
    "src/repro_torch/faults/plan.py": {"_cyc", "bank_down",
                                       "bank_rebuilding", "stutter_busy"},
    "src/repro_torch/faults/inject.py": {"*"},
    "src/repro_torch/obs/planes.py": {"lat_bin"},
    "src/repro_torch/obs/serve.py": {"_add_counts",
                                     "update_serve_telemetry"},
    "src/repro_torch/runtime/kvbank.py": {
        "_as_pool", "append_token", "recode", "_clamped_table",
        "plan_reads", "gather_kv", "_as", "_count", "pool_write_index",
        "write_lanes", "pool_mark_stale", "pool_write_layer",
        "pool_write_layer_fused", "pool_read_sets", "_plan_from_tables",
        "read_latencies", "pool_plan", "pool_install", "_budget_rows",
        "pool_recode", "pool_permute"},
}
HOST_FUNCTIONS: Dict[str, Set[str]] = {
    "src/repro_torch/core/__init__.py": {"*"},
    "src/repro_torch/core/codes.py": {"*"},
    "src/repro_torch/core/controller.py": {"jtables"},
    "src/repro_torch/core/dynamic.py": {"priors_layout"},
    "src/repro_torch/core/state.py": {
        "make_tunables", "batch_tunables", "active_ints", "derive_geometry",
        "make_params", "fault_states", "init_state", "init_states"},
    "src/repro_torch/core/system.py": {
        "drain_bound", "summarize_batch", "CodedMemorySystem.__init__",
        "CodedMemorySystem.batch_tunables", "CodedMemorySystem.init",
        "CodedMemorySystem.init_batch", "CodedMemorySystem.check_trace",
        "CodedMemorySystem.run", "CodedMemorySystem.summarize"},
    "src/repro_torch/faults/__init__.py": {"*"},
    "src/repro_torch/faults/plan.py": {
        "init_fault_state", "stack_fault_states", "FaultPlan.*",
        "plan_from_spec"},
    "src/repro_torch/obs/planes.py": {
        "init_telemetries", "init_telemetry", "_host", "TelemetrySnapshot.*",
        "_find_tele", "snapshot"},
    "src/repro_torch/obs/serve.py": {
        "init_serve_telemetry", "ServeSnapshot.*", "ServeLog.*", "_Req.*",
        "snapshot", "format_summary"},
    "src/repro_torch/runtime/kvbank.py": {
        "parity_members", "pool_init", "init_state", "pool_coded"},
}

_WAIVER_RE = re.compile(r"#\s*analysis:\s*([\w-]+)(.*)")


def _waivers(source: str, path: str, out: List[Finding]
             ) -> Dict[int, Set[str]]:
    """{line (1-based): waived rule ids}; a waiver also covers the line
    below it, so it can sit above a statement. A waiver with no reason
    after its rule id is a finding and waives nothing."""
    got: Dict[int, Set[str]] = {}
    for i, line in enumerate(source.splitlines(), start=1):
        for m in _WAIVER_RE.finditer(line):
            if not m.group(2).strip(" -:—"):
                out.append(Finding(
                    "waiver-reason", f"{rel(path)}:{i}",
                    f"waiver of {m.group(1)!r} names no reason: write why "
                    "the flagged code is right after the rule id",
                    line=i))
                continue
            got.setdefault(i, set()).add(m.group(1))
            got.setdefault(i + 1, set()).add(m.group(1))
    return got


def _matches(qualname: str, names: Set[str]) -> bool:
    if "*" in names or qualname in names:
        return True
    cls = qualname.split(".")[0]
    return f"{cls}.*" in names and "." in qualname


def _read(path: str, out: List[Finding]):
    try:
        with open(path, "r", encoding="utf-8") as fh:
            source = fh.read()
        return source, ast.parse(source, filename=path)
    except (OSError, SyntaxError) as e:
        out.append(Finding("parse-error", rel(path), str(e)))
        return None, None


def _imports(tree):
    """(node, module) of every absolute import in ``tree``."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node, a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node, node.module or ""


def _scope_files(entries: Iterable[str]) -> List[str]:
    files: List[str] = []
    for entry in entries:
        full = os.path.join(REPO_ROOT, entry)
        files.extend([full] if entry.endswith(".py") else python_files(full))
    return files


# --------------------------------------------------------- oracle purity
def check_oracle_purity(root: Optional[str] = None) -> List[Finding]:
    base = root if root is not None else os.path.join(REPO_ROOT,
                                                      ORACLE_SCOPE)
    out: List[Finding] = []
    for path in python_files(base):
        _, tree = _read(path, out)
        if tree is None:
            continue
        for node, mod in _imports(tree):
            if not any(mod == a or mod.startswith(a + ".")
                       for a in ORACLE_ALLOWED_ROOTS):
                out.append(Finding(
                    "oracle-purity", f"{rel(path)}:{node.lineno}",
                    f"oracle module imports {mod!r} — the golden model "
                    "must stay pure NumPy/stdlib (no torch, no shared "
                    "repro_torch code) so it cannot inherit a "
                    "misconception of the code it checks",
                    line=node.lineno))
    return out


# -------------------------------------------------------- port isolation
def check_port_isolation(paths: Optional[Iterable[str]] = None
                         ) -> List[Finding]:
    if paths is None:
        paths = python_files(PORT_ROOT) + [
            os.path.join(REPO_ROOT, f) for f in ISOLATION_EXTRA
            if os.path.exists(os.path.join(REPO_ROOT, f))]
    out: List[Finding] = []
    for path in paths:
        _, tree = _read(path, out)
        if tree is None:
            continue
        for node, mod in _imports(tree):
            if mod.split(".")[0] in BANNED_ROOTS:
                out.append(Finding(
                    "port-isolation", f"{rel(path)}:{node.lineno}",
                    f"imports {mod!r} — the port imports torch and numpy, "
                    "never JAX or the JAX package (only the tests import "
                    "both)", line=node.lineno))
    return out


# ---------------------------------------------------- cycle-surface rules
def check_device_rules(paths: Optional[Iterable[str]] = None,
                       device: Optional[Set[str]] = None,
                       host: Optional[Set[str]] = None,
                       geometry: Optional[bool] = None) -> List[Finding]:
    """host-sync + static-geometry + narrow-counter + classification
    completeness over the cycle surface. Explicit ``device``/``host`` sets
    (and ``geometry``, whether static-geometry applies) override the
    per-file maps, for the rules' own fixture tests."""
    if paths is None:
        paths = _scope_files(DEVICE_SCOPE)
    out: List[Finding] = []
    for path in paths:
        out.extend(_check_device_file(path, device, host, geometry))
    return out


def _check_device_file(path: str, device: Optional[Set[str]],
                       host: Optional[Set[str]],
                       geometry: Optional[bool]) -> List[Finding]:
    out: List[Finding] = []
    source, tree = _read(path, out)
    if tree is None:
        return out
    rpath = rel(path)
    device = DEVICE_FUNCTIONS.get(rpath, set()) if device is None else device
    host = HOST_FUNCTIONS.get(rpath, set()) if host is None else host
    if geometry is None:
        geometry = rpath.startswith(GEOMETRY_SCOPE)
    waivers = _waivers(source, path, out)

    def visit_scope(body, prefix: str):
        for node in body:
            if isinstance(node, ast.ClassDef):
                visit_scope(node.body, f"{node.name}.")
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = prefix + node.name
                is_device, is_host = (_matches(qual, device),
                                      _matches(qual, host))
                if is_device == is_host:
                    out.append(Finding(
                        "rule-classification", f"{rpath}:{node.lineno}",
                        f"function {qual!r} is classified as "
                        f"{'both' if is_device else 'neither'} device and "
                        "host code in repro_torch.analysis.rules — every "
                        "function of the cycle surface is exactly one, so "
                        "the host-sync rule covers the device code",
                        line=node.lineno))
                lint = _FunctionLint(rpath, qual, waivers, out)
                lint.counters(node)
                if is_device and not is_host:
                    lint.device(node, geometry)

    visit_scope(tree.body, "")
    return out


def _names(node) -> Set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)} | {
        n.attr for n in ast.walk(node) if isinstance(n, ast.Attribute)}


class _FunctionLint(ast.NodeVisitor):
    """One function's lint, in source order. Tracks the names bound to
    static (host) values and those bound to allocated-geometry fields as
    assignments are met. A conditional bind does not carry
    allocated-ness (``rs if traced else p.region_size`` is the sanctioned
    fallback, not a stride leak)."""

    def __init__(self, rpath: str, qual: str,
                 waivers: Dict[int, Set[str]], out: List[Finding]):
        self.rpath, self.qual = rpath, qual
        self.waivers, self.out = waivers, out
        self.static: Set[str] = set()
        self.geom: Set[str] = set()
        self.geometry = False
        self.stmts: List[int] = [0]        # the enclosing statements' lines

    def visit(self, node):
        if not isinstance(node, ast.stmt):
            return super().visit(node)
        self.stmts.append(node.lineno)
        try:
            return super().visit(node)
        finally:
            self.stmts.pop()

    def _flag(self, rule: str, node, message: str) -> None:
        line = getattr(node, "lineno", 0)
        if rule in self.waivers.get(line, set()) | self.waivers.get(
                self.stmts[-1], set()):
            return
        self.out.append(Finding(
            rule, f"{self.rpath}:{line}",
            f"in {self.qual!r}: {message}", line=line))

    # ------------------------------------------------------ entry points
    def device(self, fn, geometry: bool) -> None:
        self.geometry = geometry
        self._args(fn)
        for stmt in fn.body:
            self.visit(stmt)

    def counters(self, fn) -> None:
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                for kw in node.keywords:
                    if kw.arg in WIDE_FIELDS:
                        self._check_wide(kw.value, kw.arg)
            elif isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for tgt in targets:
                    name = (tgt.attr if isinstance(tgt, ast.Attribute)
                            else getattr(tgt, "id", None))
                    if name in WIDE_FIELDS:
                        self._check_wide(node.value, name)

    # --------------------------------------------------------- bindings
    def _args(self, fn) -> None:
        a = fn.args
        for arg in a.posonlyargs + a.args + a.kwonlyargs:
            ann = arg.annotation
            if ann is not None and _names(ann) <= STATIC_TYPES:
                self.static.add(arg.arg)

    def _bind(self, target, static: bool, geom: bool) -> None:
        if isinstance(target, ast.Name):
            (self.static.add if static else self.static.discard)(target.id)
            (self.geom.add if geom else self.geom.discard)(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for t in target.elts:
                self._bind(t, static, geom)
        elif isinstance(target, ast.Starred):
            self._bind(target.value, static, geom)

    def visit_FunctionDef(self, node) -> None:        # nested helpers
        self._args(node)
        for stmt in node.body:
            self.visit(stmt)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Assign(self, node) -> None:
        self.visit(node.value)
        tgt = node.targets[0]
        if isinstance(tgt, ast.Tuple) and isinstance(node.value, ast.Tuple) \
                and len(tgt.elts) == len(node.value.elts):
            for t, v in zip(tgt.elts, node.value.elts):
                self._bind(t, self._static(v), self._alloc(v))
        else:
            for t in node.targets:
                self._bind(t, self._static(node.value),
                           self._alloc(node.value))

    def visit_AnnAssign(self, node) -> None:
        if node.value is not None:
            self.visit(node.value)
            self._bind(node.target, self._static(node.value),
                       self._alloc(node.value))

    def visit_For(self, node) -> None:
        self.visit(node.iter)
        self._bind(node.target, self._static(node.iter), False)
        for stmt in node.body + node.orelse:
            self.visit(stmt)

    # ------------------------------------------------------- the checks
    def visit_If(self, node) -> None:
        self._branch(node.test, "if")
        self.generic_visit(node)

    def visit_While(self, node) -> None:
        self._branch(node.test, "while")
        self.generic_visit(node)

    def visit_IfExp(self, node) -> None:
        self._branch(node.test, "conditional expression")
        self.generic_visit(node)

    def visit_Call(self, node) -> None:
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in HOST_READS:
            self._flag("host-sync", node,
                       f"`.{f.attr}()` reads a tensor to the host (a "
                       "device sync each call); waive it with the reason "
                       "it exists or keep the value on the device")
        elif isinstance(f, ast.Name) and f.id in ("int", "float", "bool") \
                and node.args and not self._static(node.args[0]):
            self._flag("host-sync", node,
                       f"`{f.id}()` of a value that is not statically a "
                       "host value — of a tensor it is a device sync")
        self.generic_visit(node)

    def visit_BinOp(self, node) -> None:
        if self.geometry and isinstance(node.op, (ast.FloorDiv, ast.Mod)) \
                and self._alloc(node.right):
            op = "//" if isinstance(node.op, ast.FloorDiv) else "%"
            field = (node.right.attr if isinstance(node.right, ast.Attribute)
                     else getattr(node.right, "id", "?"))
            self._flag("static-geometry", node,
                       f"`{op} {field}` divides by the *allocated* geometry "
                       "— under a padded group allocation this mis-addresses "
                       "every sub-allocation point; index with the active "
                       "geometry (active_geometry / TunableParams.*_active)")
        self.generic_visit(node)

    def _branch(self, test, kind: str) -> None:
        if not self._static(test):
            self._flag("host-sync", test,
                       f"python {kind} on a value that is not statically a "
                       "host value (params, shapes, `is None`, a host "
                       "read's result) — on a tensor it is a device sync; "
                       "use torch.where, or waive it with its reason")

    def _check_wide(self, value, field: str) -> None:
        for n in ast.walk(value):
            narrow = (
                (isinstance(n, ast.Attribute) and n.attr in NARROW_DTYPES
                 and isinstance(n.value, ast.Name) and n.value.id == "torch")
                or (isinstance(n, ast.Call) and isinstance(n.func,
                                                           ast.Attribute)
                    and n.func.attr in NARROW_METHODS and not n.args))
            if narrow:
                self._flag("narrow-counter", n,
                           f"`{field}` is a wide (int64) statistic but is "
                           "built or accumulated through a narrower dtype "
                           "here — long runs would wrap or round")

    # -------------------------------------------------- static grammar
    def _static(self, node) -> bool:
        if isinstance(node, ast.Constant):
            return True
        if isinstance(node, ast.Name):
            return (node.id in self.static or node.id in STATIC_ROOTS
                    or node.id.isupper())         # module constants
        if isinstance(node, ast.Attribute):
            if node.attr in STATIC_ATTRS:
                return True
            chain = node
            while isinstance(chain.value, ast.Attribute):
                chain = chain.value
            root = chain.value
            if isinstance(root, ast.Name) and root.id == "self":
                return chain.attr in SELF_STATIC
            return isinstance(root, ast.Name) and (
                root.id in STATIC_ROOTS or root.id in self.static)
        if isinstance(node, ast.Subscript):
            return self._static(node.value) and self._static(node.slice)
        if isinstance(node, ast.Slice):
            return all(self._static(x) for x in (node.lower, node.upper,
                                                 node.step) if x is not None)
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            return all(self._static(e) for e in node.elts)
        if isinstance(node, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
                return True                 # structure: None-ness
            return self._static(node.left) and all(
                self._static(c) for c in node.comparators)
        if isinstance(node, ast.BoolOp):
            return all(self._static(v) for v in node.values)
        if isinstance(node, ast.UnaryOp):
            return self._static(node.operand)
        if isinstance(node, ast.BinOp):
            return self._static(node.left) and self._static(node.right)
        if isinstance(node, ast.IfExp):
            return all(self._static(x) for x in (node.test, node.body,
                                                 node.orelse))
        if isinstance(node, (ast.GeneratorExp, ast.ListComp, ast.SetComp)):
            saved = set(self.static)
            try:
                for gen in node.generators:
                    if not self._static(gen.iter):
                        return False
                    self._bind(gen.target, True, False)
                return self._static(node.elt)
            finally:
                self.static = saved
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Attribute):
                if f.attr in HOST_READS:
                    return True             # the read itself is flagged
                if f.attr in STATIC_METHODS:
                    return True
                return False
            if isinstance(f, ast.Name) and f.id in ALWAYS_STATIC_CALLS:
                return True
            if isinstance(f, ast.Name) and f.id in STATIC_CALLS:
                return all(self._static(a) for a in node.args)
            return False
        return False

    def _alloc(self, node) -> bool:
        if isinstance(node, ast.Attribute):
            if node.attr not in GEOM_FIELDS:
                return False
            base = node.value
            if isinstance(base, ast.Attribute) and isinstance(
                    base.value, ast.Name) and base.value.id == "self":
                return base.attr == "p"
            return isinstance(base, ast.Name) and base.id in STATIC_ROOTS
        if isinstance(node, ast.Name):
            return node.id in self.geom
        return False


# ------------------------------------------------------------ no fallback
def check_no_fallback(roots: Optional[Iterable[str]] = None
                      ) -> List[Finding]:
    """Flag a ``try`` that launches a ``*_cuda`` entry and falls back to a
    plain version in its handler, and a ``torch.cuda.is_available()`` test
    whose branches pick the CPU."""
    bases = list(roots) if roots is not None else [PORT_ROOT]
    out: List[Finding] = []
    for base in bases:
        for path in [base] if os.path.isfile(base) else python_files(base):
            out.extend(_check_fallback_file(path))
    return out


def _calls_named(nodes, pred) -> bool:
    for root in nodes:
        for n in ast.walk(root):
            if isinstance(n, ast.Call):
                f = n.func
                name = (f.attr if isinstance(f, ast.Attribute)
                        else getattr(f, "id", ""))
                if pred(name):
                    return True
    return False


def _is_available_test(test) -> bool:
    return any(isinstance(n, ast.Attribute) and n.attr == "is_available"
               and isinstance(n.value, ast.Attribute)
               and n.value.attr == "cuda" for n in ast.walk(test))


def _names_cpu(nodes) -> bool:
    return any(isinstance(n, ast.Constant) and n.value == "cpu"
               for root in nodes for n in ast.walk(root))


def _check_fallback_file(path: str) -> List[Finding]:
    out: List[Finding] = []
    source, tree = _read(path, out)
    if tree is None:
        return out
    waivers = _waivers(source, path, out)

    def flag(node, message):
        if "no-fallback" in waivers.get(node.lineno, ()):
            return
        out.append(Finding("no-fallback", f"{rel(path)}:{node.lineno}",
                           message, line=node.lineno))

    for node in ast.walk(tree):
        if isinstance(node, ast.Try):
            if _calls_named(node.body, lambda s: s.endswith("_cuda")) and \
                    _calls_named(node.handlers, lambda s: "plain" in s
                                 or s.endswith("_ref")):
                flag(node, "a kernel launch falls back to its plain version "
                     "in an exception handler — a card whose kernel fails "
                     "would run the plain PyTorch version unasked; let the "
                     "error raise")
        elif isinstance(node, (ast.If, ast.IfExp)) and \
                _is_available_test(node.test):
            branches = (node.body + node.orelse if isinstance(node, ast.If)
                        else [node.body, node.orelse])
            if _names_cpu(branches):
                flag(node, "torch.cuda.is_available() picks the CPU — an "
                     "entry point runs on the card unless its caller names "
                     "the CPU, and raises without one")
    return out


# ------------------------------------------------------------- layer entry
def run(strict: bool = False) -> List[Finding]:
    del strict
    out = check_oracle_purity()
    out += check_port_isolation()
    out += check_device_rules()
    out += check_no_fallback()
    return out
