"""Public API: the reference's C API (Opt.h:40-76) on torch (port of
opt_tpu/runtime/api.py).

  Opt_NewState            -> NewState(device=...)
  Opt_ProblemDefine       -> state.problem_define(energy, kind)
  Opt_ProblemPlan         -> state.problem_plan(problem, dims)
  Opt_SetSolverParameter  -> plan.set_solver_parameter(name, value)
  Opt_ProblemInit/Step    -> plan.init(inputs) / plan.step()
  Opt_ProblemSolve        -> plan.solve(inputs)
  Opt_ProblemCurrentCost  -> plan.current_cost()

Every tensor of a plan lives on the state's device.  NewState() puts it
on the card ("cuda") and raises where torch sees none; NewState(device=
"cpu") asks for the CPU, as the tests do.  Inputs arrive as numpy arrays
(or tensors already on that device) and bind() puts them there.

Five engines run the solver (solver/core.py) behind its operator seam:
"torch", the plain engine for every supported energy
(compile/plan_fns.FuncsOperator; on the card its graph reads run K9 and
K10); "cuda", the hand-written whole-grid kernels for image_warping
(ops/warp_cuda.WarpOperator; GN's classic PCG runs as one K13 launch an
outer step, ops/stream_cuda.warp_resident_backend); "stream", image_warping's inner PCG on the
streamed hat-space kernels (ops/stream_cuda.StreamOperator), for large
grids; "stream3d", the volumetric ARAP energy's on its own hat-space
kernels (ops/stream3d_cuda.Stream3DOperator); and "graph", a graph
energy's inner PCG on K11 over its materialized partials
(ops/graph_cuda.GraphOperator).  engine="auto" picks a kernel engine
exactly when warp_cuda.supports(plan), vol_cuda.supports(plan) or
graph_cuda.supports(plan) -- a decision on the energy, dtype and device,
never a fallback after a failure -- and by size: stream_cuda.prefers_stream
between "cuda" and "stream", stream3d_cuda.prefers_stream3d between
"torch" and "stream3d".

A graph's vertex indices arrive as {"G": {"v0": ..., "v1": ...}} or as
"G.v0", "G.v1" keys; bind checks them and builds each slot's CSR incidence
once on the host (cached on the plan by the indices' bytes).
"""

from __future__ import annotations

import numpy as np
import torch

from ..compile.plan_fns import FuncsOperator, ProblemFunctions
from ..dsl.env import EnergyEnv
from ..dsl.spec import ProblemSpec
from ..ops import graph_cuda, stream3d_cuda, stream_cuda, vol_cuda, warp_cuda
from ..parallel.dispatch import solve_sharded_auto
from ..solver.core import (
    SOLVER_PARAMETER_DEFAULTS,
    Layout,
    SolverConfig,
    make_solver,
)
from .trace import PhaseTable, span

GN_KINDS = ("gaussNewtonGPU", "gauss_newton", "gaussNewton", "GN")
LM_KINDS = ("LMGPU", "levenberg_marquardt", "levenbergMarquardt", "LM")
ENGINES = ("torch", "cuda", "stream", "stream3d", "graph")


class Problem:
    def __init__(self, energy, kind):
        self.energy = energy
        self.kind = kind
        if kind in GN_KINDS:
            self.uses_lambda = False
        elif kind in LM_KINDS:
            self.uses_lambda = True
        else:
            raise ValueError(f"unknown solver kind {kind!r}")


class OptState:
    """Opt_NewState parity (Opt_InitializationParameters, Opt.h:8-35).

    device: where every tensor of this state's plans lives: "cuda[:i]"
    (the default, which raises where torch sees no CUDA device) or
    "cpu".  collect_kernel_timing records the time of each phase (bind,
    init, step_N, solve: runtime/trace.PhaseTable), on the card with CUDA
    events and no synchronize inside the solve, and prints the reference's
    timing table when a solve finishes."""

    def __init__(
        self,
        device="cuda",
        double_precision=False,
        verbosity=0,
        collect_kernel_timing=False,
        use_materialized_jacobian=False,
        use_fused_jtj=False,
        pcg_variant="classic",
        guarded_invert_type="CERES",
        jacobi_scaling="ONCE_PER_SOLVE",
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} asked for, but torch sees no CUDA device")
        self.double_precision = double_precision
        self.verbosity = verbosity
        self.collect_kernel_timing = collect_kernel_timing
        self.use_materialized_jacobian = use_materialized_jacobian
        self.use_fused_jtj = use_fused_jtj
        self.pcg_variant = pcg_variant
        self.guarded_invert_type = guarded_invert_type
        self.jacobi_scaling = jacobi_scaling
        self.dtype = torch.float64 if double_precision else torch.float32

    def problem_define(self, energy, kind="gaussNewtonGPU"):
        return Problem(energy, kind)

    def problem_plan(self, problem, dims):
        return Plan(self, problem, dims)

    def problem_solve(self, plan, inputs):
        plan.init(inputs)
        while plan.step():
            pass
        return plan.current_cost()

    # CamelCase aliases for reference-API parity
    ProblemDefine = problem_define
    ProblemPlan = problem_plan
    ProblemSolve = problem_solve


def NewState(**kwargs):
    return OptState(**kwargs)


def _run_energy(energy, env):
    """Run a user energy definition: a callable taking the env, or a path
    to a Python file executed with the DSL names as globals."""
    if callable(energy):
        energy(env)
        return
    path = str(energy)
    with open(path) as f:
        src = f.read()
    ns = env.namespace()
    ns["__name__"] = "<energy>"
    exec(compile(src, path, "exec"), ns)


def state_from_numpy(flat, device, dtype):
    """The port's solver state from the flat numpy arrays that
    Plan.save_state writes -- in either package ({x.<name>, ssq,
    prev_cost, radius, decrease_f, n_iter, done}).  Unknowns come back as a
    dict name -> tensor under "x"; floats are cast to dtype."""
    state = {"x": {}}
    for key, arr in flat.items():
        arr = np.asarray(arr)
        if np.issubdtype(arr.dtype, np.floating):
            t = torch.as_tensor(arr).to(device=device, dtype=dtype)
        elif key == "done":
            t = torch.as_tensor(arr.astype(bool), device=device)
        else:
            t = torch.as_tensor(arr.astype(np.int32), device=device)
        if "." in key:
            group, name = key.split(".", 1)
            state.setdefault(group, {})[name] = t
        else:
            state[key] = t
    return state


class Plan:
    """A shape-specialized solver over one problem (opt.Plan, o.t:158-164)."""

    def __init__(self, state: OptState, problem: Problem, dims):
        self.state = state
        self.problem = problem
        self.dims = dims
        self.device = state.device
        self.spec = ProblemSpec()
        _run_energy(problem.energy, EnergyEnv(self.spec, dims))
        if not self.spec.terms:
            raise ValueError("energy defined no residual terms")

        self.funcs = ProblemFunctions(self.spec, state.dtype, state.device)
        self.config = SolverConfig(
            uses_lambda=problem.uses_lambda,
            guarded_invert_type=state.guarded_invert_type,
            jacobi_scaling=state.jacobi_scaling,
            use_materialized_jacobian=state.use_materialized_jacobian,
            use_fused_jtj=state.use_fused_jtj,
            pcg_variant=state.pcg_variant,
        )
        self.layout = Layout(self.funcs.unknown_shapes)
        (self._init_fn, self._step_fn, self._cost_fn,
         self._full_solve_fn) = make_solver(
            self.config, state.dtype, self.funcs.use_preconditioner)
        self.solver_params = dict(SOLVER_PARAMETER_DEFAULTS)
        # the streamed engines' PCG backend: None picks classic for GN and
        # LM on grids and volumes (stream_cuda.pick_variant)
        self.stream_variant = None
        self.engine = None  # the engine of the last init() or solve()
        self.variant = None  # and its stream backend, if it ran one
        self._state = None
        self._op = None
        self._cleaned = False
        self.timer = PhaseTable(state.collect_kernel_timing, state.device)
        # (graph, slot, vertex count, index bytes) -> CSR incidence
        self._incidence_cache = {}

    # -- parameters -----------------------------------------------------------

    def set_solver_parameter(self, name, value):
        if name == "nIter":
            # the live nonlinear-iteration counter is itself a settable
            # SolverParameters entry in the reference
            # (solverGPUGaussNewton.t:186-201,2382-2398)
            if self._state is None:
                raise RuntimeError(
                    "nIter is the live iteration counter; set it after init"
                )
            self._state = dict(self._state)
            self._state["n_iter"] = torch.tensor(int(value), dtype=torch.int32,
                                                 device=self.device)
            self._state["done"] = torch.tensor(False, device=self.device)
            return
        if name not in self.solver_params:
            raise KeyError(f"unknown solver parameter {name!r}")
        self.solver_params[name] = value

    SetSolverParameter = set_solver_parameter

    # -- data binding (util.initParameters parity, util.t:677-721) ------------

    def _tensor(self, name, arr):
        if isinstance(arr, torch.Tensor):
            if arr.device != self.device:
                raise ValueError(
                    f"{name}: tensor on {arr.device}, plan is on "
                    f"{self.device}")
        else:
            arr = torch.as_tensor(np.asarray(arr)).to(self.device)
        return arr.to(self.state.dtype)

    def bind(self, inputs):
        """(x, data): the unknowns packed into one flat vector on the
        plan's device, and data = {"images": name -> (H, W, C) tensor,
        "params": name -> 0-d tensor, "graph_indices": graph -> slot ->
        (E,) int32, "graph_incidence": graph -> slot -> (order, rowptr)}."""
        images = {}
        unknowns = {}
        for name, im in self.spec.images.items():
            if name not in inputs:
                raise KeyError(f"missing image input {name!r}")
            arr = self._tensor(name, inputs[name])
            spatial = im.ispace.shape
            if tuple(arr.shape) == spatial:
                if im.channels != 1:
                    raise ValueError(
                        f"{name}: expected {im.channels} channels")
                arr = arr[..., None]
            expect = spatial + (im.channels,)
            if tuple(arr.shape) != expect:
                raise ValueError(
                    f"{name}: shape {tuple(arr.shape)} != expected {expect} "
                    f"(note layout: dims "
                    f"({', '.join(d.name for d in im.ispace.dims)}) "
                    f"-> array shape {expect})"
                )
            (unknowns if im.is_unknown else images)[name] = (
                arr.contiguous())
        params = {}
        for name in self.spec.params:
            if name not in inputs:
                raise KeyError(f"missing param input {name!r}")
            params[name] = torch.tensor(float(inputs[name]),
                                        dtype=self.state.dtype,
                                        device=self.device)
        indices, incidence = self._bind_graphs(inputs)
        return self.layout.pack(unknowns), {
            "images": images, "params": params, "graph_indices": indices,
            "graph_incidence": incidence}

    def _bind_graphs(self, inputs):
        """Each graph's slot indices on the device, checked as the JAX
        package checks them (opt_tpu/runtime/api.py:454-483), and each
        slot's CSR incidence (graph_cuda.incidence), built once per index
        array."""
        indices, incidence = {}, {}
        for gname, g in self.spec.graphs.items():
            gin = inputs.get(gname)
            slots = {}
            for sname, slot in g.slots.items():
                if gin is not None and sname in gin:
                    v = gin[sname]
                elif f"{gname}.{sname}" in inputs:
                    v = inputs[f"{gname}.{sname}"]
                else:
                    raise KeyError(f"missing graph indices {gname}.{sname}")
                if isinstance(v, torch.Tensor):
                    v = v.cpu()
                vnp = np.asarray(v)
                n_verts = slot.ispace.shape[0]
                if vnp.size and (vnp.min() < 0 or vnp.max() >= n_verts):
                    raise ValueError(
                        f"graph {gname}.{sname}: vertex index out of range "
                        f"[0, {n_verts}): min={vnp.min()}, max={vnp.max()}")
                slots[sname] = (vnp.astype(np.int32).reshape(-1), n_verts)
            if len({a.shape for a, _ in slots.values()}) != 1:
                raise ValueError(f"graph {gname}: slot length mismatch")
            indices[gname], incidence[gname] = {}, {}
            for sname, (a, n_verts) in slots.items():
                key = (gname, sname, n_verts, a.tobytes())
                csr = self._incidence_cache.get(key)
                if csr is None:
                    csr = self._incidence_cache[key] = graph_cuda.incidence(
                        a, n_verts)
                indices[gname][sname] = torch.as_tensor(a).to(self.device)
                incidence[gname][sname] = tuple(
                    torch.as_tensor(c).to(self.device) for c in csr)
        return indices, incidence

    # -- engines -----------------------------------------------------------------

    def _pick_engine(self, engine):
        """Resolve engine="auto" as the JAX package's auto route does for
        f32 grids (opt_tpu/runtime/api.py:719-768): when the hand-written
        kernels hold this plan on a CUDA device, image_warping goes to
        "stream" for large grids (stream_cuda.prefers_stream: GN from
        2048^2 pixels, LM above 512^2) and "cuda" below, volumetric ARAP
        to "stream3d" from 64^3 voxels (stream3d_cuda.prefers_stream3d),
        and a graph energy that K11 holds (graph_cuda.supports) to
        "graph"; everything else to "torch".  (The JAX package sends
        graphs to its XLA program; its graph kernel is opt-in.)  An
        explicit kernel engine needs only the energy to match; on CPU
        tensors its kernel wrappers run their plain versions."""
        if engine == "auto":
            if warp_cuda.supports(self):
                return ("stream" if stream_cuda.prefers_stream(self)
                        else "cuda")
            if (vol_cuda.supports(self)
                    and stream3d_cuda.prefers_stream3d(self)):
                return "stream3d"
            if graph_cuda.supports(self):
                return "graph"
            return "torch"
        if engine not in ENGINES:
            raise ValueError(f"engine must be auto or one of {ENGINES}: "
                             f"{engine!r}")
        if engine == "graph" and not graph_cuda.supports_plan(self):
            raise ValueError(
                "engine='graph' holds f32 graph energies whose images share "
                "one vertex space, with no Exclude, pointwise vertex terms "
                "and at most 32 leaves on 8 slots a graph group "
                "(ops/graph_cuda.plan_meta)")
        if engine == "stream3d" and not vol_cuda.supports_energy(self):
            raise ValueError(
                "engine='stream3d' holds only "
                "energies.volumetric_mesh_deformation, f32")
        if (engine in ("cuda", "stream")
                and not warp_cuda.supports_energy(self)):
            raise ValueError(
                f"engine={engine!r} holds only energies.image_warping, f32")
        return engine

    def _operator(self, engine, data):
        if engine == "cuda":
            op = warp_cuda.WarpOperator(data)
            if (not self.config.uses_lambda
                    and self.config.pcg_variant == "classic"):
                # GN's whole PCG as one K13 launch an outer step, as the
                # JAX package's whole-solve kernel runs it in one kernel
                op.pcg_backend = stream_cuda.warp_resident_backend(op)
            return op
        if engine == "stream":
            return stream_cuda.StreamOperator(
                data, self.config.uses_lambda, self.stream_variant)
        if engine == "stream3d":
            return stream3d_cuda.Stream3DOperator(
                data, self.config.uses_lambda, self.stream_variant)
        if engine == "graph":
            return graph_cuda.GraphOperator(
                self.funcs, data, self.layout, self.config.uses_lambda,
                graph_cuda.plan_meta(self))
        return FuncsOperator(self.funcs, data, self.layout)

    def _bind_engine(self, engine, inputs):
        """Pick the engine, bind the inputs and build its operator."""
        with span("opt.bind"):
            self.engine = self._pick_engine(engine)
            x, data = self.bind(inputs)
            self._op = self._operator(self.engine, data)
            self.variant = getattr(self._op, "variant", None)
        return x

    # -- lifecycle --------------------------------------------------------------

    def init(self, inputs, engine="auto"):
        """Opt_ProblemInit: bind data, compute the initial cost."""
        with self.timer.on():
            x = self._bind_engine(engine, inputs)
            self._state = self._init_fn(x, self._op, self.solver_params)
        self._cleaned = False
        return self

    Init = init

    def step(self):
        """Opt_ProblemStep: one outer iteration; returns 1 while running
        (plan.step contract, solverGPUGaussNewton.t:1913-2349)."""
        assert self._state is not None, "call init() first"
        s = self._state
        n = int(s["n_iter"])
        if n >= int(self.solver_params["nIterations"]) or bool(s["done"]):
            self._cleanup()
            return 0
        self.timer.step = n
        with self.timer.on():
            self._state = self._step_fn(s, self._op, self.solver_params)
        if self.state.verbosity > 1:
            print(f"--cost after step {n}: "
                  f"{float(self._state['prev_cost']):.16f}")
        return 1

    Step = step

    def _cleanup(self):
        """Solver cleanup contract (solverGPUGaussNewton.t:1902-1910):
        print 'final cost=' and the timing table."""
        if self._cleaned:
            return
        self._cleaned = True
        if self.state.verbosity > 0:
            print(f"final cost={self.final_cost():.16f}")
        self.timer.evaluate()

    def solve(self, inputs, engine="auto", mesh=None):
        """Opt_ProblemSolve: init and the whole outer loop with no host
        synchronization inside; returns the final cost.

        engine: "auto" (see _pick_engine), "torch", "cuda", "stream",
        "stream3d" or "graph".
        mesh: a chain of slabs from parallel.mesh.make_mesh; the solve then
        runs sharded over it (parallel/dispatch.py), engine "auto",
        "halo", "stream" or "stream3d", and leaves the unknowns readable
        in the global layout.
        A kernel error propagates: there is no fallback to another
        engine."""
        with self.timer.on(), span("opt.solve"):
            if mesh is not None:
                solve_sharded_auto(self, inputs, mesh, engine)
            else:
                x = self._bind_engine(engine, inputs)
                self._state = self._full_solve_fn(x, self._op,
                                                  self.solver_params)
            cost = self.final_cost()
        self._cleaned = False
        self._cleanup()
        return cost

    Solve = solve

    # -- results ------------------------------------------------------------------

    def current_cost(self):
        assert self._state is not None
        return float(self._cost_fn(self._state, self._op))

    CurrentCost = current_cost

    def final_cost(self):
        """The cost the reference prints as 'final cost=' (prevCost,
        solverGPUGaussNewton.t:1903): cost after the last update."""
        assert self._state is not None
        with span("opt.read"):
            return float(self._state["prev_cost"])

    @property
    def x(self):
        """name -> unknown tensor (views of the flat solver vector)."""
        return self.layout.views(self._state["x"])

    def unknowns(self):
        assert self._state is not None
        return {k: v.cpu().numpy() for k, v in self.x.items()}

    # -- checkpoint / resume ----------------------------------------------------
    # The full solver state round-trips through one .npz in the JAX
    # package's format, so a solve can resume across processes and across
    # the two packages.

    def save_state(self, path):
        assert self._state is not None, "nothing to save; call init() first"
        flat = {}
        for k, v in self._state.items():
            if k == "x" or (k == "ssq" and v.ndim):
                # per-unknown arrays, as the JAX package writes them
                for n, arr in self.layout.views(v).items():
                    flat[f"{k}.{n}"] = arr.cpu().numpy()
            else:
                flat[k] = v.cpu().numpy()
        np.savez(path, **flat)

    def load_state(self, path):
        assert self._op is not None, "bind data first (init or solve)"
        with np.load(path) as loaded:
            st = state_from_numpy(dict(loaded), self.device,
                                  self.state.dtype)
        for name, shape in self.funcs.unknown_shapes.items():
            got = st["x"].get(name)
            if got is None:
                raise ValueError(
                    f"{path}: checkpoint missing unknown {name!r}")
            if tuple(got.shape) != tuple(shape):
                raise ValueError(
                    f"{path}: unknown {name!r} shape {tuple(got.shape)} "
                    f"does not match plan shape {tuple(shape)} -- "
                    "checkpoint is from a different problem size"
                )
        for key in ("prev_cost", "n_iter", "done"):
            if key not in st:
                raise ValueError(f"{path}: checkpoint missing {key!r}")
        st["x"] = self.layout.pack(st["x"])
        if isinstance(st.get("ssq"), dict):  # LM's saved diagonal
            st["ssq"] = self.layout.pack(st["ssq"])
        self._state = st
        self._cleaned = False
        return self
