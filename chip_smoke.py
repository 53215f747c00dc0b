#!/usr/bin/env python3
"""
Smoke run of the PyTorch / CUDA port (``tpl_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--parent-csrc DIR]... [--kernels-only]
                          [--host-profile TICKS]

1. prints the card's name and power limit, builds the CUDA kernels from
   ``tpl_tpu_torch/csrc`` (one ``nvcc`` per source, all started together)
   and the host C routes and the shared-memory store engine of
   ``tpl_tpu_torch/native`` (``g++``), and prints
   the build time and the ptxas register / memory report; then
   the latency probe: the SM clock under load and the card's cycles per
   dependent operation (``csrc/latency_probe.cu``), on one line with the
   card's name and power limit;
2. action-min kernel phase: at the demo grid (T=10, S=201, DS=37, L=21)
   runs the lat/lon action-min kernel against its plain PyTorch version on
   the card, on seeded inputs and on every backward slice of a real solve,
   and the fused backward-slice kernel (the slice's producers and the
   action-min in one launch) against its plain version on the same 8
   slices; prints the largest differences and the tie cells; times both
   through their bare launchers (into buffers made once) and through their
   wrappers, in turns, the action-min also at two smaller grids, at other
   tile heights and beside an empty kernel of the same launch shape;
   prints the kernel launches (torch.profiler) and the host wall of one
   solve's backward pass with and without the fusion;
3. slice phase (open loop): drives ``EnvironmentApp`` + ``PlanningApp``
   with the DP lat/lon planner on ``demo/country_follow`` at the demo param
   set's full grid for 5 replans; checks every published trajectory, that
   each replan launched the kernel once per backward slice, and the last
   replan's solve against the plain version on the CPU;
4. DP closed-loop phase: ``SimStandalone`` on ``demo/country_follow`` with
   ``dp_lat_lon_planner`` at the full demo grid and the demo control set's
   ``model_predictive_controller`` (H=60, 20 iterations, float64) for 200
   ticks of 0.01 s, rule checker on; checks zero violations, no emergency
   plan, finite controls, the ego's speed at the end, 8 action-min launches
   per replan and one iLQR launch per controller solve, and the last solve
   against the plain version on the CPU; prints the per-tick control and
   total wall times and the per-replan wall;
5. iLQR kernel phase: the tracking-MPC kernel against the plain
   ``make_update_fn`` on the card, float64, on the ``_mpc_setup`` inputs
   of ``__graft_entry__.py`` (8 and 20 iterations) and on 3 warm-started
   solves recorded in the closed loop; prints the largest |x|, |u|
   differences, the cost difference, mu_step and iteration counts, and
   both times per solve; runs the kernel's profiling instantiation, checks
   that its result is bit-equal and prints one "phases" line per solve:
   microseconds per iteration by phase (thread 0's ``clock64()`` cycles over
   the SM clock);
6. RSTP closed-loop phase: ``SimStandalone`` on ``demo/country_follow``
   with the scenario's own param sets, no override (``path_vel_decomp_
   planner``, ``use_fused``, H=250, replanning every tick, plus the MPC) for
   400 ticks; the same checks (an emergency plan only while the collision
   screen's hard brake is latched, as in the JAX package's own loop, over
   t=0.04-1.03 s, and out of it at the end), exactly 2 ``ilqr_rstp`` and 1
   ``rstp_rampify`` launches per replan, and the last fused step re-run on
   the CPU by the plain versions from the recorded carry and inputs;
   prints the per-tick total, planning and control walls;
7. the same on ``demo/country_overtake`` for 200 ticks, with the
   planner's collision screen off (with it on, the JAX package's own loop
   latches the hard brake for 196 of the 200 ticks and the ego stops) and
   no emergency plan: a standing car ahead is the leader of the replans;
8. RSTP kernel phase: both ``ilqr_rstp`` instantiations against
   ``update_reference`` on the card on the first cold and 3 warm solves of
   the follow loop, ``rstp_rampify`` against its plain version, bit for
   bit, on seeded inputs (a random-walk limit, a constant one) and on two
   of the loop's own calls; prints the differences, the times through the
   bare launchers and the wrappers, the solves' "phases" lines as in 5 and
   one per scan (microseconds per phase, cycles per step);
9. host C routes: each of the four routes of ``tpl_tpu_torch/native``
   (``project``, ``resample``, ``rampify_profile``, ``rampify_corridor``)
   against its numpy path, on the calls the follow loop itself made
   (recorded as the loop made them) and on seeded inputs; prints which
   route each of the four took in the loop and how often;
10. batched tracking MPC: ``optim.batched.make_batched_update_fn`` for
   ``trajectory_tracking_mpc`` at B=2048, H=60, 8 iterations, HEUN, the
   ``_mpc_setup`` inputs with ``x0 + 0.01 * b`` (the batch of the JAX
   package's bench), in float64 and in float32: one launch of
   ``ilqr_tracking_mpc_batched`` (persistent, a warp per scenario) per
   update, all 2048 results against the plain batched update on the card,
   per scenario (float64: x, u, lam atol = rtol = 1e-9 on at least 99 % of
   the scenarios and equal mu_step and iteration counts on all; float32 and
   the reason for a share: see BATCH_* / F32_* below), every 64th scenario
   and the last bit-equal to single launches (float64); the profiling
   instantiation bit-equal, scenario 0's microseconds per iteration by phase
   beside the single solve's on the same problem, and the batch's line
   searches by the candidate they took against the candidates the plain
   version's sequential search rolls; the same for the bench's scenario 0
   alone in the team geometry (a block a scenario, which batches of at
   most the printed size take); the resident scenarios per SM (the
   occupancy calculator, both geometries) and the shared memory of a
   block's shared part and of a scenario; on seeded warm starts in float32,
   the shares of scenarios whose mu_step or stopping iteration differ,
   kernel against plain float32 and plain float32 against plain float64;
   ms per batch through the bare launcher and through the
   wrapper at B = 1, 132, 264, 2048 on the bench's batch and with every
   start near the course (every scenario 8 iterations), solves per second,
   the plain version's time, the roofline bound (the candidates the
   sequential search rolls), the longest scenario's chain in the batch's
   precision, the larger of the two (the bound of any design) and the
   floor of this design (each scenario's chain with the rounds its line
   searches take);
11. FAS closed loops: ``SimStandalone`` on ``demo/country_follow`` with
   ``poly_lat_dp_lon_planner`` (the demo planning set's block: the sweep at
   1 x 20, lon T=10, S=201, V=37, A=20, P=200, env 10 x 201 x 31) and then
   ``lattice_planner`` (its defaults) active, the scenario's other sets, 300
   ticks each, the chain's launch counters set to 0 just before each loop
   and read just after; checks zero violations, no emergency plan, finite
   controls and 12 launches of the chain's kernels per replan (9 backward
   slices, 1 forward pass, 1 sweep with its selection, 1 rampify start
   scan);
   prints the end state beside the JAX package's CPU loop's, the per-replan
   wall (median, max) and the launches of one replan (torch.profiler);
   keeps the inputs of each loop's first replan;
12. FAS kernels: ``csrc/lon_dp.cu`` (every backward slice of a seeded
   demo-width solve and of each loop's first solve, A=20 and A=7: the
   chosen jerks as indices on all but 0.1 % of the nodes, the values to
   the stated tolerance, and every slice bit for bit against the plain
   version on the CPU; the slice's block plan, a "plan" line: s rows a
   block, the largest box's bytes (``lon_kernel.box_bytes``), shared
   memory, threads, blocks, registers; the forward and reeval passes),
   ``csrc/poly_lat.cu``
   (the sweep and its selection in one launch, seeded at 1 x 20 and 21 x 13
   and each loop's, 1 x 20 and 21 x 13: the maps against the plain sweep,
   the winner and its cost against the plain selection on the kernel's own
   maps) and the
   start mode of ``csrc/rstp_rampify.cu`` (seeded, and each loop's at its
   path step) against their plain versions on the card (a lon slice, the
   forward pass and the loops' rampify scans also bit for bit against the
   plain versions on the CPU; the RSTP mode of the rampify source still bit
   for bit); times through the bare launchers and the wrappers on the FAS
   loop's inputs, the wrappers on the lattice loop's, the plain versions'
   times, ``bound_ms`` and ``chain_ms`` (the sweep's:
   ``sweep_select_chain_ms``, with the selection's updates on the loop's
   maps); the forward pass and the sweep also from CUDA graphs
   (``graph_ms``, the sweep at both loops' grids); the profiling
   instantiations of the forward pass (lane 0's us by phase: staging,
   lookup, terms, pick, next) and of the sweep (thread 0's us a block:
   coefficients, samples, segments, times, collision, reduce, arrive; the
   last block's selection), each
   bit-equal to the plain instantiation, a "phases" line each; the first
   replan of each loop (``runtime_dp``) into the result line;
12b. the NaN rule: the lon backward slice (two slices from a next slice
   whose row S // 2 is NaN), the forward and reeval passes (slice 2 NaN at a
   index 1), the action-min (37 x 5 x 3, row 18 NaN) and the fused slice
   (the demo grid's slice T - 2, row S // 2 NaN), every channel NaN and the
   cost alone, each bit for bit against its plain version on the CPU, NaN
   equal to NaN (a NaN constraint makes the least constraint NaN: the lon
   node costs inf with the first jerk, the action-min takes action 0 with
   its own cost and constraint; the first NaN cost of the least constraint
   wins); then a NaN in a value input, which the kernels' terms keep as the
   plain versions' clamps do: the lon kernels with a NaN in the distance
   map or the path's v_max (``scenes.lon_nan_values``), the fused slice and
   the action-min with NaN cells in the DP distance map or NaN lane bounds,
   the sweep and its selection with NaN lane bounds at 1 x 20 and 21 x 13
   (``scenes.poly_lat_nan_bounds``); and the selection driven into its
   edges through the sweep's inputs at 1 x 20 and 21 x 13
   (``scenes.poly_lat_select_edge``: no obstacle, every candidate
   infeasible, the first update's cost NaN, every cost NaN), against the
   plain selection on the kernel's own maps and (the NaN-free two, with
   ``--parent-csrc``) the parent's;
13. rollout planner closed loops: ``SimStandalone`` with
   ``idm_sampling_planner`` on ``demo/country_overtake`` (the demo planning
   set: 8 candidates of 100 steps, a replan every 0.05 s) and then with
   ``poly_sampling_planner`` on ``demo/country_follow`` (2 x 1 x 3
   candidates of 25 steps, a replan every 0.2 s), the scenario's other
   sets, 300 ticks each, the launch counters set to 0 just before each loop
   and read just after; checks zero violations, no emergency plan, finite
   controls and exactly one ``idm_rollout`` and one ``idm_evaluate`` launch
   per IDM replan (the grid's one launch, ``poly_sampling``, per poly
   replan); prints the launches per
   replan and per tick, the end state beside the JAX package's CPU loop's
   and the per-replan wall (median, max);
   keeps the first replan's inputs;
14. IDM kernels: ``csrc/idm_rollout.cu`` and ``csrc/idm_evaluate.cu``
   against their plain versions on the card, every candidate, on the
   seeded scenes of tests/test_idm_kernel.py (a stop cell, off-road
   excursions, a parked collider the collision screen must hit), on an
   oncoming car (C=256, T=100: the interaction screen's hull tests must
   run and hit), on the IDM loop's first replan and on the JAX bench's
   scene at its full width (bench.py ``_idm_setup``, rebuilt in
   ``tpl_tpu_torch/scenes.py``: NR=801, O=12, P=16, K=16, T=100,
   C=16,384), and on the hairpin scene (``scenes.idm_hairpin_scene``, C=8
   and 256: a ref line that doubles back, where the exact pruned searches
   must decide); no candidate may pass the tolerance nor flip ``invalid``;
   prints the largest differences, the hull tests and path projections the
   gates let through, the candidates with an interaction cost and a
   flipped selection; times both through the bare launcher and the wrapper
   in turns at C=16,384 and at the loop's C=8, the plain versions at
   C=16,384 (the compared run), and prints rollouts/s at C=16,384 (C over
   the two kernels' ms), blocks an SM and registers a thread (ptxas), the
   needed-work ``bound_ms`` (the work an exact search needs on the bench's
   plain rollout: ``idm_kernel.rollout_work``, ``evaluate_work``) beside
   the full-scan one, and ``chain_ms``;
15. poly sampling kernel: ``csrc/poly_sampling.cu`` against its plain
   version and the numpy oracle ``_eval_candidates`` on the JAX bench's
   scene (C=30), tests/test_poly_kernel.py's two scenes and the poly loop's
   first replan, and against its plain version on the bench's scene with a
   NaN cost at index 17, NaN costs at 23 and 9 and an exact tie of the
   least cost (the winner's index equal, the first NaN winning, its rows to
   tolerance, NaN equal to NaN); the profiling instantiation bit-equal, a
   "phases" line (us a block: coefficients, steps, screen, sums, arrival;
   the last block's selection); times through the bare launcher and the
   wrapper and from CUDA graphs, ``chain_ms`` beside the pricing of the
   earlier two-launch design;
16. graph DP closed loop: ``SimStandalone`` on ``demo/country_follow``
   with ``dp_poly_planner`` active (the demo planning set's block: env 10 x
   201 x 21 x 21 directions, graph 10 x 15 x 21, two levels) and the
   scenario's other sets, 300 ticks, rule checker on, the launch counters
   set to 0 just before the loop and read just after; checks zero
   violations, no emergency plan, finite controls, per replan one
   ``dir_dist_map``, four ``poly_eval_edges`` (a level: the field's slice
   straight ahead, then the edges) and one ``poly_propagate`` launch,
   and the end state against the JAX package's CPU loop's;
   prints the medians of ``runtime_environment`` and ``runtime_planning``;
   keeps the first replan's grids and start state;
17. graph DP kernels: ``csrc/dir_dist_map.cu`` against its plain version
   on tests/test_dp_poly_planner.py's scene (``scenes.dp_poly_env``),
   seeded random occupancy (also at ray_steps 40) and the loop's first
   grid, cell for cell (the scene also against the plain version on the
   CPU), with the samples one march a slice and one march for all slices
   need; ``csrc/poly_planner.cu``'s edge evaluation at four start indices
   (two capped at 400,000 edges) on both levels over the scene's and the
   loop's field (t, ds, l exact, s and the cost to 4 float32 ulps; the
   largest differences printed; the steps taken those the edges need) and
   its propagation on the kernel's own end points and on seeded graphs
   of 1, 2 and 3 levels with equal least costs, NaN costs and nodes
   without edges (every selection, cost and the trajectory equal); the
   three profiling instantiations bit-equal, a "phases" line each (the
   field: us a block in staging, march and write-out; the evaluation:
   cycles an edge in the fits, the polynomial steps, the steps past te, the
   lookups, the sums; the propagation: us a block for the last level and
   the arrival, the last block's lower levels and backtrack); times each
   kernel through its bare launcher and its wrapper in turns on the loop's
   first replan and from CUDA graphs (``graph_ms``), the plain versions,
   ``bound_ms`` (the needed work; beside it one march a slice / every step
   of every edge) and ``chain_ms`` (the propagation's beside the pricing
   of the earlier launch a level);
18. the controllers beside the spatial MPC: ``SimStandalone`` on
   ``demo/country_follow`` with the scenario's own sets (the RSTP planner,
   fused, H=250, the collision screen on) and each of
   ``model_predictive_controller_time``, ``feedforward_controller``,
   ``flat_controller`` and ``direct_controller`` active, 200 ticks each,
   the launch counters set to 0 just before each loop and read just after;
   checks finite controls, the ego moving, the rule violations and the end
   state against the JAX package's CPU loop's (tests/jax_controller_loops.py,
   pinned in CONTROLLER_JAX_END), 2 ``ilqr_rstp`` and 1 ``rstp_rampify``
   launches per replan, and exactly one ``ilqr_tracking_mpc_time`` launch per
   time-MPC solve (none for the host controllers); prints the per-tick
   control wall (median, max) of the ticks each controller drove; keeps
   three of the time MPC's warm-started solves;
19. time-indexed MPC kernel: ``csrc/ilqr_tracking_mpc_time.cu`` against the
   plain ``make_update_fn`` on the card, float64, on the seeded cases of
   ``scenes.mpc_time_case`` (a straight reference at UTM magnitude, a curved
   one, a warm-started two-round solve, a reference that ends inside the
   horizon) and on the three recorded loop solves: x, u, lam to 1e-9 (atol +
   rtol), equal mu_step and iterations; prints the largest differences;
   the profiling instantiation bit-equal on every case, a "phases" line
   for the straight case and the first loop solve; times those two
   through the bare launcher and the wrapper in turns, the plain version,
   ``bound_ms`` and ``chain_ms``; the loop's first solve, median and max
   (the wrapper binds the library with its code loaded and its
   shared-memory limit set, so the first launch waits on neither);
20. ``python -m tpl_tpu_torch.simulation.tplsim run --scenario
   demo/country_follow --headless --no-reload --max-ticks 200`` on the card
   as a child process: exit code 0 (zero rule violations) and its summary;
20a. the demo legs: ``tplsim run --headless --seed 0`` on ``demo/oval_lap``,
   ``leader_brake``, ``urban_light`` and ``urban_crossing`` for 200 ticks
   each, four child processes side by side, the scenarios' own sets (RSTP
   fused, H = 250, the collision screen on; the MPC, H = 60): exit code,
   rule violations and emergency ticks equal to the JAX package's own CPU
   loop over the same ticks (``DEMO_JAX_END``, printed by
   ``tests/jax_demo_loops.py``), the end position and speed within 0.05;
21. record and replay: ``SimRecorder`` over 100 ticks of the vendored loop
   (written under ``build/``), read back with ``load_recording`` and stepped
   into a fresh store by ``SimReplay``, every state equal;
22. genopt MPC: the sympy front end's tracking MPC
   (``scenes.genopt_mpc_config``, float64, H=60, 8 iterations) solved on
   the card by the kernel generated from its config (the printed struct in
   ``csrc/ilqr_generic_body.cuh``; its ``nvcc`` runs in a thread beside
   the phases from 3 on, and its seconds are printed), one launch an
   update, against its plain version on the card, the native problem's
   kernel solve and the same genopt solve on the CPU (x, u atol 1e-6, the
   cost rtol 1e-9); the bare launcher's, the wrapper's and the plain
   version's ms, ``bound_ms`` / ``chain_ms``, the shared-memory /
   workspace split and a "phases" line (the profiling instantiation
   bit-equal), the kernels' registers and local bytes; then each
   ``optimizers`` factory with a kernel solves once at its horizon of 300
   on the card through its kernel (the tracking MPCs through the generic
   one).  Then "iLQR generic": ``csrc/ilqr_generic.cu`` on
   ``ref_line_smoother_k``, ``ref_line_smoother_dk`` and
   ``velocity_profile_time`` at H = 250 and 300 (at 300 with a 24 KB
   shared-memory limit: the workspace path), cold with EULER and warm with
   HEUN, float32 and float64 against the plain version on the card (at
   the RSTP tolerance and at 1e-9), times, bounds, the split and "phases"
   lines, every instantiation's registers and local bytes; the batch
   through ``optim.batched`` on CUDA tensors at B = 1, 64 and 2,048 of
   ``ref_line_smoother_k`` and of the genopt MPC, every scenario bit-equal
   to its single launch, against the plain batched update on the card at
   B <= 64, timed, with the geometry the launcher picks (a block a
   scenario, or resident warps at 2,048: slots a block, blocks an SM, a
   slot's bytes) and scenario 0's "phases" line.  With ``--parent-csrc``
   holding another ``ilqr_generic.cu`` (and ``ilqr_generic_body.cuh``,
   ``ilqr_generic_entries.cuh``, ``ilqr_jet.cuh`` and the headers they
   include), its native library and the genopt MPC's source against its
   headers are built beside the first phases, and every case of both
   phases (and the RSTP profiles at the same shapes) must keep its bits
   against it, timed in turns.  Then "tracking MPCs, generic kernel": both
   tracking-MPC factories' solvers at H = 200 and 300 through the generic
   kernel against their plain versions on the card at 1e-9, timed, and
   the batched time-indexed MPC at B = 64 and 2,048, every scenario
   bit-equal to its single launch, against the plain batched update at
   64.  The vendored loop's controller (horizon 60) is checked to launch
   ``ilqr_tracking_mpc`` and never the generic kernel.  Then "RSTP
   smooth_only":
   ``SimStandalone`` on ``demo/country_follow`` with the scenario's sets
   and ``smooth_only`` turned on in the planning store, 200 ticks: one
   ``ref_line_smoother_k`` launch and one ``ilqr_rstp`` launch a replan,
   finite controls, zero violations, the ego moving, the replan walls;
23. user problems through the generic kernel: the three examples' torch
   problems (``tpl_tpu_torch.examples.{crane_2d, simple_vehicle,
   solver_crosscheck}``: H = 100 / 80 / 40, up to 60 / 30 / 100
   iterations, the vehicle's float32 solve up to 10) traced into the generic kernel's struct
   (``tpl_tpu_torch/optim/trace.py``; their sources, float32 and float64,
   and the traced ``trajectory_tracking_mpc``'s, float64, built by one
   ``nvcc`` each in a thread beside the phases from 3 on, the seconds
   printed): each example's ``main`` on the card (its own checks; the
   launch counters set to 0 just before and read just after: one
   ``ilqr_generic`` launch an update), each example's solve through its
   ``Solver`` (``route == "ilqr_generic"``) in float32 and float64
   against the plain iLQR on the card and on the CPU (USER_TOL), float32
   timed with ``bound_ms`` / ``chain_ms`` and a "phases" line; the crane's
   batch through ``optim.batched`` (float64) at B = 64 and 2,048: one
   launch, every scenario bit-equal to its single launch, four scenarios
   within 1e-9 of ``update.reference`` on the CPU and, at 64, every one of
   the plain batched update on the card, timed, solves/s, the bounds and
   the design floor; the traced ``trajectory_tracking_mpc`` at H = 60
   (float64, HEUN, cold and warm) against its hand-written struct (1e-9,
   equal iterations) and ``csrc/ilqr_tracking_mpc.cu`` (x, u atol 1e-6,
   cost rtol 1e-9), the three timed;
23a. traced operations through the generic kernel: the two problems of
   ``scenes.USER_PROBLEMS`` (a quadratic tracking MPC, H = 100, its
   captured weights in ``einsum`` / ``@`` and its captured reference read
   by the step index; a vehicle on a captured 200 x 200 cost map through
   ``blerp`` with softplus, hypot, sigmoid, erf, log1p, expm1, relu and
   the reductions, H = 80), traced and built (float32 and float64, one
   ``nvcc`` each) in a thread beside the phases from 3 on: each solved
   through its ``Solver`` on the card at its own 20 iterations (one
   ``ilqr_generic`` launch, the counts set to 0 just before) and timed
   there with ``bound_ms`` / ``chain_ms``, registers and local bytes;
   against its plain iLQR on the card, equal iterations and mu_step:
   float64 at its own iterations at USER_OWN_TOL and over the iterations
   where another rounding order stays within 1e-12 (``USER_SETTINGS``
   ``it_exact``: 3 and 2) at USER_OPS_TOL, float32 over ``it_f32`` (5 and
   4) at USER_F32_TOL, and the float32 own solve against the plain
   float64 one parting beyond USER_OWN_TOL (the control); the float64
   batch at B = 64 and 2,048 at its own iterations: one launch, finite,
   timed, solves/s, the bounds; over ``it_exact`` iterations every
   scenario bit-equal to its single launch, four within USER_OPS_TOL of
   ``update.reference`` on the CPU; at 64 all of the plain batched update
   on the card (USER_OPS_TOL over ``it_exact``, USER_OWN_TOL over
   USER_OWN_BATCH_IT);
24. the batched DP slice (``latlon_backward_slice`` at B > 1: the resident
   blocks walking the work items) at the demo grid on
   ``scenes.dp_batch_scenes`` (per-scenario scenes, tables and ``l_trg``,
   NaN distance cells in one scenario): at B = 1 and 8 every backward
   slice bit-equal to the plain version on the CPU (NaN equal to NaN), at
   B = 32 chained through the kernel, and every scenario to its
   one-scenario launch, one launch a slice; a batch solve at B = 8 is 8
   batched launches and each plan its own solve's; one batched launch at
   B = 8 and 32 timed against B one-scenario launches from CUDA graphs and
   by events, with scenarios a second of slice time and the blocks
   launched; its profiling instantiation bit-equal, with a "phases" line
   (thread 0's us an item); the kernels' registers and stack bytes
   (``cuobjdump -res-usage``), SASS instruction counts and, for a kernel
   with ``clock64()`` stamps, the instructions between them with the
   action loop's opcodes by kind; the tree's ``numRegs`` /
   ``localSizeBytes`` (``cudaFuncGetAttributes``); the wrapper, the plain
   version and the bounds (also under ``--kernels-only``);
25. ``tpl_tpu_torch.parallel.dryrun_multichip(device_count)`` at its full
   widths (the MPC at B = 4 a card, the IDM sweep at C = 16 a card, the DP
   batch at B = 8 a card on the 10 x 201 x 37 x 21 grid, the env build at
   B = 4 a card), the launch counters set to 0 just before and read just
   after: the batched MPC, both IDM kernels and the batched slice (8 a
   card) launched; run twice, each part's wall printed first and warm;
26. the multi-process deployment: the env, planning and control apps of
   ``tpl_tpu_torch.application.mains`` as three child processes on the
   card (new interpreters, ``TPL_TPU_NO_RELOAD=1``, the libraries built by
   this process and loaded from ``build/``; each child is this script with
   ``--deploy-child APP APP_ID`` and prints its launch counters, its
   updates and each store's lock round trips when SIGTERM ends it) and
   ``tplsim attach --scenario demo/country_follow`` in real time to
   DEPLOY_LEG_T * 2 s of sim time, all under one app id; this process
   attaches a ``GuiServer`` by the app id on a free port and reads
   ``/state.json`` and ``/params.json`` (and ``/scene.png``: a PNG, or
   where matplotlib is missing the 500 with its ImportError).  Leg 1 runs
   the scenario's own sets (the vendored RSTP planner, the tracking MPC);
   in it a ``POST /param`` turns the RSTP planner's ``write_debug_data``
   off and on, and the planner's published debug must lose and regain
   ``opt_path``.  At
   DEPLOY_LEG_T s a ``POST /select`` switches the planning process to
   ``dp_lat_lon_planner``.  Checks: every child exits 0 and none is left
   (killed in a ``finally`` otherwise), zero rule violations, the ego moved,
   ``ilqr_rstp`` and ``rstp_rampify`` launches under the RSTP planner, 8
   fused DP slice launches per DP replan under the DP planner, one
   tracking-MPC launch per control solve; prints the replans and control
   solves per second of each process, each process's lock and read round
   trips (ms) by store, the store sizes and the phase's wall;
27. prints the card's name and power limit and one JSON line describing the
   kernels (launches on the main path and per tick or per DP replan, the
   largest difference to the plain version, the kernel's time through its
   bare launcher ``ms`` and through its wrapper ``wrapper_ms``, the plain
   version's time, the roofline bound ``bound_ms`` and the critical-path
   bound ``chain_ms`` from this run's shapes, iteration counts and probe
   latencies), then ``{"ok": true, "device": {...}}`` as the last line.
   The ``latlon_action_min`` row counts every launch of the source's
   action-min (on the main path all of them go through the fused entry,
   which has its own row, ``latlon_backward_slice``).  The four FAS rows
   carry the lattice loop's launches, largest differences and wrapper
   times under ``lattice_*`` beside the FAS loop's, the lon slices' share
   of differing jerks (``jerk_flip_share``) and the sweep's largest
   relative cost difference (``max_cost_rel_err``).  The three rollout
   planner rows carry their own loop's launches (per replan and per tick);
   the forward pass's and the sweep's rows their "phases" (``phases_us``)
   and, with ``--parent-csrc``, the other source's times in turns
   (``parent_ms``); the four FAS rows each loop's first replan
   (``first_replan_ms``, ``lattice_first_replan_ms``);
   the IDM rows their times
   at C=16,384 (``candidates``), at the loop's width (``loop_ms``),
   ``rollouts_per_s``, ``selection_flips``, ``blocks_per_sm``,
   ``registers``, ``spill_bytes``, the full-scan bound
   (``full_scan_bound_ms``; ``bound_ms`` is the needed-work one) and the
   counts behind it (``needed_work``).  The three graph DP rows
   carry their loop's launches (per replan and per tick) and the loop's
   ``runtime_environment`` / ``runtime_planning`` medians.  The time-MPC row
   carries its loop's launches and the per-tick control walls of the four
   controllers' loops.  The ``latlon_backward_slice_batched`` row carries
   the dryrun's launches (``launches``, ``dryrun_launches``), its time at
   B = 8 from CUDA graphs (``ms``) beside 8 one-scenario launches
   (``single_launches_ms``), both by events, scenarios a second of slice
   time, the same at B = 32 (``by_batch``), the other sources' times in
   turns (``parent_graph_ms``), its "phases" (``phases_us``), the kernels'
   ``numRegs`` / ``localSizeBytes`` and the dryrun's wall times.  The rows
   of the kernels the multi-process deployment launches carry those
   launches (``deploy_launches``, counted in the child processes).
   Each phase prints its seconds.

With ``--parent-csrc DIR`` (a directory holding another version of any of
the kernel sources ``latlon_action_min.cu``, ``ilqr_tracking_mpc.cu``,
``ilqr_rstp.cu``, ``rstp_rampify.cu``, ``idm_rollout.cu``,
``idm_evaluate.cu``, ``ilqr_tracking_mpc_time.cu``, ``lon_dp.cu``,
``dir_dist_map.cu``, ``poly_planner.cu``, ``poly_sampling.cu``,
``poly_lat.cu`` and the headers they include, for
example ``git show`` of an earlier commit's; may be given more than once) the kernel phases also build that version with
the same flags, run both on the same inputs through the bare launchers in
turns (other, tree, tree, other) and print the largest difference of the
results and the four times; for the action-min, the rampify scan, the two
IDM kernels (the IDM kernels on the JAX bench's scene, the loop's first
replan, the seeded scenes and the hairpin; the evaluation of the tree's
rollout), the tracking MPC's single solve and its profiling
instantiation, the time-indexed MPC (every seeded and recorded solve) and
the lon backward slice (every slice of the seeded, FAS-loop and
lattice-loop solves; a source of the earlier one-thread-a-node launcher
is recognised), the lon forward pass (the seeded, FAS-loop and
lattice-loop solves, A=20 and A=7, and the reeval of each trajectory with
more rows than slices; also timed from CUDA graphs), the fused backward
slice (the 8 real slices of phase 2), the graph DP's field (every case of phase 17), edge
evaluation (both levels of every case of phase 17; a launcher without the
slice's scratch is recognised) and propagation (every case of phase 17; a
source of the launch a level is recognised; all three also timed from
CUDA graphs) and the batched slice (every scenario at B = 1, 8 and 32 of
phase 24, from CUDA graphs and by events in turns; a source that exports
``latlon_backward_slice_profile`` prints its "phases" line, and every
source its kernels' registers and SASS counts) a difference other than
0.0 raises (NaN equal to NaN); the
poly grid (a source of the two launches is recognised) must keep every
candidate's rows and cost on every case of phase 15 and the winner on
every case without a NaN cost, and is timed by CUDA events and from CUDA
graphs; the lateral sweep with its selection (a source of the two
launches, ``poly_lat_select``, is run as such) must keep the collision
distance's bits, the cost's bits (within SWEEP_PARENT_RTOL for a source
whose sweep sums in another order, one without ``poly_lat_sweep_profile``)
and the winner and its cost on every case of phase 12 (timed by events
and from CUDA graphs); with a ``latlon_action_min.cu`` the DP loop's
first replan is timed in four fresh processes, that source's and the
tree's in turns, the libraries bound before the loop; a time-MPC, field or evaluation source
that exports a ``*_profile`` entry also prints its "phases" lines.  The batched tracking MPC is held to the other version's batched
entry (a grid of one block per scenario where the source predates the
persistent kernel) on the bench's batch, near the course and on seeded
warm starts at every size of BATCH_SIZES, both precisions: every
scenario's bits (a difference raises), and the times in turns.  A
rampify source of the earlier one-buffer launcher is recognised, and if it
exports ``rstp_rampify_profile`` with stamps after its staging, backward
scan, forward scan and write-out, its "phases" lines are printed too.

With ``--kernels-only`` the run stops after phase 2, the rampify part of
phase 8, the time-indexed MPC's seeded cases (checked, profiled, against
``--parent-csrc``), every backward slice of the seeded demo-width lon
solve and of ``scenes.LON_EDGE``'s grids (bit for bit on the CPU, against
``--parent-csrc``), the lon forward pass of seeded demo-width solves (A=20
and A=7) and the sweep with its selection seeded at 1 x 20, 21 x 13 and
5 x 11 (against the plain versions and ``--parent-csrc``; their "phases"
lines), phase 12b, phase
17 with seeded occupancy in place of the graph DP loop's first replan and
phase 24: no loop is driven and no result line printed.

With ``--host-profile TICKS`` the run builds, then drives the vendored RSTP
loop on ``demo/country_follow`` for TICKS ticks under ``cProfile`` twice,
with the host C routes off (the numpy paths) and on, and prints for each the
10 functions that lead by cumulative time, the share of the four routed
functions, and the medians of the tick's phases; no result line.

Any failure raises (nonzero exit).  Without CUDA it exits nonzero before
printing any result.
"""

import ctypes
import hashlib
import json
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np

# tolerances (see tests/test_torch_latlon_solver.py)
COST_RTOL, COST_ATOL = 1e-6, 1e-3
CONSTR_ATOL = 1e-4
TRAJ_ATOL = 1e-3
MAX_TIE_SHARE = 1e-3
# the float64 iLQR kernel against its plain version (tests/test_torch_ilqr.py)
MPC_X_ATOL = 1e-6
MPC_COST_RTOL = 1e-9
# the float32 RSTP solves, kernel against plain: both stop within a
# relative cost change of 1e-6, where a line-search acceptance (and so
# mu_step, and now and then one iteration more) is decided by float32
# rounding; along the weakly determined directions of a converged profile
# the two then part by up to ~6e-3 (m/s, s) (the kernel's body run on the
# CPU against the plain version, 10 cases)
RSTP_X_ATOL = 2e-2
RSTP_COST_RTOL = 1e-5
# the fused step on the card against the same step on the CPU (plain)
FUSED_PATH_ATOL = 5e-3      # m
FUSED_V_ATOL = 5e-2         # m/s

# the batched tracking MPC, kernel against the plain batched update on the
# card, per scenario.  The bench's batch adds 0.01 * b to EVERY state of the
# start, the steering angle included, so scenario b starts at delta = 0.01 b
# rad: most scenarios start far off the course (their first line search
# fails and they stop after one iteration), some start beside a pole of
# tan(delta) (b = 157, 471, ...), and their rollouts amplify a rounding by
# many orders of magnitude.  So the tolerance is held per scenario, and a
# stated share of the scenarios must meet it; the rest are printed, and must
# be finite and (float64) take the same decisions.
# float64: x, u, lam atol = rtol = 1e-9 and the cost rtol 1e-9 (the same
# operations in the same order; the kernel's body run on the CPU agrees to
# 1e-12 on well-conditioned scenarios); mu_step and iteration counts equal
# on every scenario.
# float32: both are float32 runs of the same algorithm; whether a line
# search accepts a step whose cost change is a rounding of the cost is
# decided by rounding, so mu_step, the iteration at which a solve stops and,
# along weakly determined directions, a control may part: the tolerance
# tests/test_torch_kernel_cuda.py states for float32 solves (x, u, lam 2e-2,
# cost 1e-5), with mu_step and the iteration count, on the stated share.
BATCH_ATOL = BATCH_RTOL = 1e-9
BATCH_MIN_SHARE = 0.99
F32_X_ATOL = 2e-2
F32_COST_RTOL = 1e-5
F32_MIN_SHARE = 0.98
BATCH = 2048
PROFILE_SKIP_TICKS = 110
BATCH_ITERATIONS = 8
BATCH_SIZES = (1, 132, 264, 2048)
# the batches the batched kernel runs: (name, spread of the starts, seed of
# the warm start): the bench's, every start near the course, seeded warm
# starts near the course (mixed iteration counts)
BATCH_CASES = (("bench", None, None), ("near course", 8, None),
               ("seeded", 8, 11))

DEMO_SPEC = dict(t_steps=10, s_steps=201, ds_steps=37, l_steps=21)
MIN_REPLANS = 5
TICK = 0.1
MAX_TICKS = 60

DP_TICKS = 200
LOOP_TICKS = 400            # 4 s of the closed loop (test_demo_follow_short)
OVERTAKE_TICKS = 200
MPC_H = 60
RSTP_H = 250
RECORD_SOLVES = (50, 100, 150)
RECORD_REPLANS = (100, 200, 300)
FAS = "poly_lat_dp_lon_planner"
LATTICE = "lattice_planner"
FAS_TICKS = 300
# the grids each planner runs at on demo/country_follow: (lateral LD, SD,
# S), (lon T, S, V, A, P), (env T, S, L); the FAS planner's from the demo
# planning set's block, the lattice planner's its defaults
FAS_GRID = {FAS: ((1, 20, 201), (10, 201, 37, 20, 200), (10, 201, 31)),
            LATTICE: ((21, 13, 201), (10, 201, 37, 7, 200), (10, 201, 21))}
# the JAX package's own loops on the CPU, 300 ticks on demo/country_follow,
# that planner active with the scenario's sets: (t, x, v) at the end
FAS_JAX_END = {FAS: (2.99, 39.51, 8.97), LATTICE: (2.99, 42.77, 10.80)}
# (row, the wrapper the chain calls, how many of its first calls are kept:
# every backward slice of the first solve, T - 1 at both planners' grids)
FAS_ENTRIES = (("lon_dp_backward", "backward_slice", 9),
               ("lon_dp_forward", "forward", 1),
               ("poly_lat_sweep_select", "sweep_select", 1),
               ("rstp_rampify_start", "scan_start", 1))
SWEEP_RTOL = 1e-9
# the sweep's cost against another version of its kernel: a block's cost
# sum may take another order (the serial sum, the warps' tree)
SWEEP_PARENT_RTOL = 1e-12
# (row, source, the XLA program of the JAX package it replaces)
FAS_ROWS = (
    ("lon_dp_backward", "lon_dp.cu",
     "tpl_tpu/planning/dyn_prog/lon_kernel.py:197"),
    ("lon_dp_forward", "lon_dp.cu",
     "tpl_tpu/planning/dyn_prog/lon_kernel.py:344"),
    ("poly_lat_sweep_select", "poly_lat.cu",
     "tpl_tpu/planning/dyn_prog/poly_lat_kernel.py:121, "
     "tpl_tpu/planning/dyn_prog/poly_chain_kernel.py:78"),
    ("rstp_rampify_start", "rstp_rampify.cu",
     "tpl_tpu/planning/dyn_prog/poly_chain_kernel.py:227"))


# the rollout planners: each drives SimStandalone on its demo scenario with
# the scenario's other sets; the JAX package's own loops on the CPU, 300
# ticks, that planner active: (scenario, t, x, v) at the end
IDM = "idm_sampling_planner"
POLY = "poly_sampling_planner"
ROLLOUT_TICKS = 300
ROLLOUT_JAX_END = {IDM: ("demo/country_overtake", 2.99, 48.803, 10.723),
                   POLY: ("demo/country_follow", 2.99, 37.695, 7.643)}
# the IDM kernels against their plain versions on the card, every
# candidate: rtol = atol = 1e-5 (the JAX package's own lanes-vs-vmap
# tolerance; the card's and torch's transcendentals may part by an ulp and
# a closed loop carries it), no candidate past it, every ``invalid`` equal
IDM_TOL = 1e-5
IDM_C = 16384               # the JAX bench's candidates a launch
# the poly grid: the winner's index equal; its float64 rows to 1e-9 against
# the plain version (the coefficient solves sum in another order), to 1e-4
# against the numpy oracle (tests/test_poly_kernel.py)
POLY_ROW_TOL = 1e-9
POLY_ORACLE_TOL = 1e-4
ROLLOUT_ROWS = (
    ("idm_rollout", "idm_rollout.cu",
     "tpl_tpu/planning/idm_sampling/idm_kernel.py:444"),
    ("idm_evaluate", "idm_evaluate.cu",
     "tpl_tpu/planning/idm_sampling/idm_kernel.py:928"),
    ("poly_sampling", "poly_sampling.cu",
     "tpl_tpu/planning/poly_sampling/poly_kernel.py:76"))


# the graph DP planner: SimStandalone on demo/country_follow with the demo
# planning set's own block (env 10 x 201 x 21 x 21 directions, graph 10 x
# 15 x 21, two levels); the JAX package's own loop on the CPU, 300 ticks,
# that planner active with the scenario's other sets: (t, x, v) at the end
DP_POLY = "dp_poly_planner"
DP_POLY_TICKS = 300
DP_POLY_GRID = ((10, 201, 21, 21), (2, 10, 15, 21))
DP_POLY_JAX_END = (2.99, 43.882, 12.251)
DP_POLY_END_ATOL = 0.05     # m, m/s: both loops choose the same edges
# launches of one replan: the field; a level's evaluation (two launches: the
# field's slice straight ahead, then the edges); the propagation of every
# level and the backtrack
DP_POLY_PER_REPLAN = {"dir_dist_map": 1, "poly_eval_edges": 4,
                      "poly_propagate": 1}
# the edge evaluation, kernel against its plain version on the card: the
# same float32 operations in the same order, neither contracted; allowed: 4
# float32 ulps on s and the cost, t / ds / l exact
DP_EVAL_RTOL = 4 * 2.0 ** -23
DP_POLY_ROWS = (
    ("dir_dist_map", "dir_dist_map.cu",
     "tpl_tpu/planning/dyn_prog/dp_environment.py:206"),
    ("poly_eval_edges", "poly_planner.cu",
     "tpl_tpu/planning/dyn_prog/poly_planner_kernel.py:189"),
    ("poly_propagate", "poly_planner.cu",
     "tpl_tpu/planning/dyn_prog/poly_planner_kernel.py:275"))


# the controllers beside the spatial MPC: SimStandalone on
# demo/country_follow with the scenario's own sets (the RSTP planner, fused,
# H=250, collision screen on) and that controller active, 200 ticks; the JAX
# package's own loops on the CPU (tests/jax_controller_loops.py): (t, x, y,
# v, rule violations) at the end.  The screen latches the hard brake over
# ticks 4-103 in both packages, and the constant-deceleration fallback
# drives while it does.
TIME_MPC = "model_predictive_controller_time"
CONTROLLER_TICKS = 200
CONTROLLER_JAX_END = {
    TIME_MPC: (1.99, 21.1633, 12.3621, 2.4110, 0),
    "feedforward_controller": (1.99, 22.8113, 12.6315, 4.8501, 0),
    "flat_controller": (1.99, 22.6170, 12.6498, 4.6655, 0),
    "direct_controller": (1.99, 22.2709, 12.5070, 3.4880, 0)}
CONTROLLER_END_ATOL = 0.05  # m, m/s
# the time-MPC solves of its loop kept for the kernel phase (warm starts)
RECORD_TIME_SOLVES = (5, 40, 80)
# the time-indexed MPC kernel against its plain version on the card (both
# float64; the card's and the CPU's libm part in the last bits)
MPC_TIME_TOL = 1e-9
MPC_TIME_H, MPC_TIME_T = 60, 40     # HORIZON_MAX, the demo set's horizon
# the sympy front end's tracking MPC on the card: its plain float64 iLQR
# against the native problem's kernel solve and the same solve on the CPU,
# at the float64 kernel's tolerance against its plain version
# (tests/test_torch_kernel_cuda.py: the two differ in how the derivatives
# and the lookups are formed, and the card's libm from the CPU's)
GENOPT_H = 60
GENOPT_X_ATOL = 1e-6
GENOPT_COST_RTOL = 1e-9
# the generic AL-iLQR kernel: float64 against its plain version (relative to
# the largest |x|), the horizons, a shared-memory limit that puts a block's
# arrays in the workspace, the batch sizes, the smooth_only loop's ticks
GENERIC_TOL = 1e-9
GENERIC_H = (250, 300)
GENERIC_SMALL_SMEM = 24 * 1024
GENERIC_BATCHES = (1, 64, 2048)
GENOPT_HORIZON_MAX = 100    # the genopt MPC solver's capacity (H=60 active)
TRACKING_H = (200, 300)     # the tracking MPCs through the generic kernel
TIME_BATCHES = (64, 2048)   # the batched time-indexed MPC
# the sources of the generic kernel that --parent-csrc compares
GENERIC_SOURCES = ("ilqr_generic.cu", "ilqr_generic_body.cuh",
                   "ilqr_generic_entries.cuh", "ilqr_jet.cuh")
SMOOTH_TICKS = 200
# USER_TOL: the user problems' traced kernel solves against their plain
# versions.  float64: GENERIC_TOL (x, u scaled by the largest |x|; cost),
# equal iterations and mu_step, except the vehicle's (30 iterations, still
# descending at the last: the struct's other rounding order grows to 9e-7
# in x over them, tests/test_torch_trace.py), held at USER_VEHICLE_TOL.
# float32: where a float32 solve stops and which line-search step it takes
# is decided by rounding (tests/test_torch_kernel_cuda.py RSTP_X_ATOL), so
# iterations may differ; the crane (60 iterations, converged at 23) and the
# unicycle (28) agree to USER_F32_TOL (x scaled by the largest |x|: 5 cm at
# the crane's 10 m).  The vehicle's float32 solve, still descending, parts
# from any other rounding order after about 12 iterations (on the CPU its
# plain float32 solve against float64: 8.5e-6 of the largest |x| and 8.8e-7
# in cost after 10 iterations, 8.2e-4 and 3.0e-4 after 15, 5.0e-2 and
# 0.19 after 30, where float32 stops at 26; on the card, NVIDIA H100 80GB
# HBM3, the traced kernel against the plain iLQR after 10 iterations:
# 7.4e-6 / 8.2e-7 on the card, 4.1e-6 / 8.2e-7 on the CPU, after 15
# 1.4e-3 / 1.4e-3): its float32 solve is checked at
# USER_VEHICLE_F32_ITERATIONS, equal iterations and mu_step, at
# USER_VEHICLE_F32_TOL
USER_F32_TOL = 5e-3
USER_VEHICLE_TOL = 1e-5
USER_VEHICLE_F32_ITERATIONS = 10
USER_VEHICLE_F32_TOL = 1e-4
USER_BATCHES = (64, 2048)   # the crane's batch: the JAX bench's 2,048
# the traced operations' two problems (scenes.USER_PROBLEMS): float64 kernel
# solves against the plain version on the card over the iterations where
# another rounding order stays within it (scenes.USER_SETTINGS it_exact;
# x, u scaled by the largest |x|, and the cost), float32 at it_f32 within
# USER_F32_TOL, equal iterations and mu_step both
USER_OPS_TOL = 1e-12
# and at their own 20 iterations (the single solves, and the batch at B = 64
# over USER_OWN_BATCH_IT) within USER_OWN_TOL, equal iterations and mu_step:
# the largest of the readings of tests/user_problem_readings.py (the printed
# struct compiled with g++ against the plain float64 iLQR on the CPU) and
# of this script on the card, raised to the next power of ten above them
# with room for another compiler's rounding; the float32 kernel's own solve
# against the plain float64 one, the control, parts far beyond it.  The
# cost map's batch of spread starts is held over 5 iterations: at its own
# 20 the plain float64 batch parts from itself, its starts moved by 1e-14,
# by up to 5e-2 of the largest |x| (several scenarios take other iteration
# counts), where no tolerance tells a right kernel from a wrong one
USER_OWN_TOL = {"quadratic_tracking_mpc": 1e-9, "cost_map_vehicle": 1e-6}
USER_OWN_BATCH_IT = {"quadratic_tracking_mpc": 20, "cost_map_vehicle": 5}
# the batched fused slice: the batch sizes checked against the plain
# version on the CPU, those checked against the one-scenario launches on
# the card, those timed, and the one in the kernels' JSON line
SLICE_BATCHES = (1, 8)
SLICE_CARD_BATCHES = (32,)
SLICE_BATCHES_TIMED = (8, 32)
SLICE_BATCH_TIMED = 8
# the demo legs: tplsim run on the card against the JAX package's own CPU
# loop over the same ticks (tests/jax_demo_loops.py prints these: end t, x,
# y, v, rule violations, emergency ticks), the scenarios' own sets, the
# collision screen on in all four (leader_brake's latches the hard brake
# over 100 of the 200 ticks in the JAX loop)
DEMO_SCENARIOS = ("demo/oval_lap", "demo/leader_brake", "demo/urban_light",
                  "demo/urban_crossing")
DEMO_TICKS = 200
DEMO_JAX_END = {
    "demo/oval_lap": (1.99, 8.4241, -0.0000, 3.6973, 0, 0),
    "demo/leader_brake": (1.99, 21.1786, 12.3065, 2.2127, 0, 100),
    "demo/urban_light": (1.99, 22.7877, 0.2596, 6.8388, 0, 0),
    "demo/urban_crossing": (1.99, 253.5160, 15.5781, 7.1086, 0, 0)}
DEMO_END_ATOL = 0.05        # m, m/s
# the tplsim phase: the vendored loop through the command line, on the card
# (200 ticks, half its earlier depth, since the demo legs run four more
# scenarios through it: to hold the script's wall)
TPLSIM_TICKS = 200
RECORD_TICKS = 100
# the multi-process deployment: sim seconds of each leg, in real time
DEPLOY_LEG_T = 10.0
DEPLOY_APPS = ("env", "planning", "control")
DEPLOY_SWITCH = "dp_lat_lon_planner"


KERNELS = ("latlon_action_min", "ilqr_tracking_mpc", "ilqr_rstp",
           "rstp_rampify", "latency_probe", "lon_dp", "poly_lat",
           "idm_rollout", "idm_evaluate", "poly_sampling", "dir_dist_map",
           "poly_planner", "ilqr_tracking_mpc_time", "ilqr_generic_f32",
           "ilqr_generic_f64")
NO_LIBRARY = None           # no single PyTorch call computes these kernels


def cuda_ms(fn, n, warm=3):
    """Mean time of fn() over n runs after ``warm`` runs, by CUDA events."""
    import torch

    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def smi(query):
    """First line of ``nvidia-smi --query-gpu=<query>
    --format=csv,noheader``."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]


def sm_clock_mhz(busy):
    """The SM clock nvidia-smi reports while the card works: ``busy()``
    queues about a second of launches, the clock is read beside them."""
    import torch

    busy()
    mhz = float(smi("clocks.sm").split()[0])
    torch.cuda.synchronize()
    return mhz


def phase_line(kernel, what, ilqr, cycles, iterations, mhz):
    """One line of a profiled solve: microseconds per iteration for the
    phases of an iteration, per solve for the others (thread 0's clock64()
    cycles over the SM clock)."""
    us = {k: v / mhz for k, v in cycles.items()}
    per_it = ", ".join(f"{k} {us[k] / max(iterations, 1):.2f}"
                       for k in ilqr.ITERATION_PHASES)
    once = ", ".join(f"{k} {us[k]:.2f}" for k in ilqr.PHASES
                     if k not in ilqr.ITERATION_PHASES)
    it_sum = sum(us[k] for k in ilqr.ITERATION_PHASES) / max(iterations, 1)
    print(f"phases {kernel} {what} ({iterations} iterations, SM {mhz:.0f} "
          f"MHz): us per iteration: {per_it} (sum {it_sum:.2f}); us per "
          f"solve: {once}; total {sum(us.values()):.2f} us")
    return us


def check_close(got, want, what):
    """Kernel vs plain nodes: cost / constr within tolerance, the chosen
    action equal except on tie cells.  Returns (max abs err, flips)."""
    import torch

    got, want = got.cpu(), want.cpu()
    np.testing.assert_allclose(got[..., 0], want[..., 0], rtol=COST_RTOL,
                               atol=COST_ATOL, err_msg=what + " cost")
    np.testing.assert_allclose(got[..., 1], want[..., 1], rtol=0,
                               atol=CONSTR_ATOL, err_msg=what + " constr")
    flips = torch.any(got[..., 2:] != want[..., 2:], dim=-1)
    return float(torch.max(torch.abs(got - want))), flips


def tie_cells(constr_o, cost_o):
    """Cells whose best and second-best action (constr, cost) lie within
    the tolerances."""
    import torch

    c, v = constr_o.double(), cost_o.double()
    cmin = c.amin(-1, keepdim=True)
    best = torch.where(c == cmin, v, torch.full_like(v, float("inf"))
                       ).argmin(-1, keepdim=True)
    cb, vb = c.gather(-1, best), v.gather(-1, best)
    other = torch.ones_like(c, dtype=torch.bool).scatter(-1, best, False)
    near = ((c - cb).abs() <= CONSTR_ATOL) & (
        (c != cb) | ((v - vb).abs() <= COST_ATOL + COST_RTOL * vb.abs()))
    return (other & near).any(-1).cpu()


def seeded_slice(lam, tllk, dev, rng, S, DS, L):
    """Seeded inputs of one backward slice on an (S, DS, L) grid: (next
    nodes, state cost, state constraint, d_fwd) and the default params'
    action tables."""
    import torch

    solve, _ = tllk.make_latlon_solver(
        dict(t_steps=4, s_steps=S, ds_steps=DS, l_steps=L), dev)
    pp = tllk.unpack_pp(torch.from_numpy(tllk.LatLonParams().packed()).to(dev))
    tables = solve.action_tables(pp)
    dds_v, dl_v = (tables[k].cpu().numpy() for k in ("dds_vals", "dl_vals"))
    nodes = np.stack([rng.uniform(0, 1e4, (S, DS, L)),
                      rng.uniform(0, 5, (S, DS, L))
                      * (rng.uniform(size=(S, DS, L)) < 0.2),
                      rng.choice(dds_v, (S, DS, L)),
                      rng.choice(dl_v, (S, DS, L))], -1)
    args = [torch.from_numpy(a.astype(np.float32)).to(dev) for a in (
        nodes, rng.uniform(0, 1e3, (S, DS, L)),
        rng.uniform(0, 2, (S, DS, L)) * (rng.uniform(size=(S, DS, L)) < .1),
        rng.uniform(-5, 60, (S, L, lam.NB)))]
    return args, tables


def action_min_call(args, tables, stream, ts_rows=None):
    """``call(fn, out)`` for the bare launchers of latlon_action_min.cu on
    one slice's inputs (``ts_rows``: the tile argument of
    ``latlon_action_min_tiled``)."""
    S, DS, L = args[0].shape[:3]
    ptrs = [a.data_ptr() for a in args] + list(tables.ptrs)
    tile = [] if ts_rows is None else [ts_rows]
    return lambda fn, out: fn(*ptrs, out.data_ptr(), S, DS, L, *tile, stream)


def kernel_phase(lam, tllk, dev, parent_csrc=None):
    import ctypes
    import torch

    T, S, DS, L = (DEMO_SPEC[k] for k in ("t_steps", "s_steps", "ds_steps",
                                          "l_steps"))
    p = tllk.LatLonParams()
    solve, _ = tllk.make_latlon_solver(DEMO_SPEC, dev)
    rng = np.random.default_rng(0)
    max_err = 0.0
    n_cells = n_ties = 0

    # (a) seeded inputs
    seeded, tables = seeded_slice(lam, tllk, dev, rng, S, DS, L)
    cases = [("seeded", seeded, tables)]

    # (b) every backward slice of a real solve: a straight road with a
    # parked car and a slower leader, inputs chained through the plain
    # version so kernel and plain see identical next-slice nodes
    dist, rl = dp_scene(T, S, L)
    dist_x, rl_t, step_t, pp = solve.prepare(dist, rl, 0.5, p.packed())
    tables = solve.action_tables(pp)
    nxt = solve.final_slice(dist_x, rl_t, step_t, pp)
    scene = (dist_x, rl_t, step_t, pp, tables)
    for i in range(T - 2, 0, -1):
        ins = solve.slice_inputs(i, dist_x, rl_t, step_t, pp)
        cases.append((f"slice {i}", [nxt, *ins], tables))
        nxt = lam.action_min_reference(nxt, *ins, tables)

    plain = {}
    for name, args, tb in cases:
        got = lam.action_min(*args, tb)
        want, constr_o, cost_o = lam.action_min_reference(
            *args, tb, return_actions=True)
        torch.cuda.synchronize()
        err, flips = check_close(got, want, name)
        ties = tie_cells(constr_o, cost_o)
        if bool(torch.any(flips & ~ties)):
            raise AssertionError(f"{name}: {int((flips & ~ties).sum())} "
                                 "non-tie cells pick another action")
        max_err = max(max_err, err)
        n_cells += flips.numel()
        n_ties += int(flips.sum())
        plain[name] = (want, ties)
        print(f"kernel check {name}: max|kernel-plain| = {err:.3e}, "
              f"tie cells {int(ties.sum())}, differing picks "
              f"{int(flips.sum())}")
    if n_ties > MAX_TIE_SHARE * n_cells:
        raise AssertionError(f"{n_ties} of {n_cells} cells pick another "
                             "action")

    # the fused slice kernel on the same 8 real slices, against its plain
    # version (slice_inputs + action_min_reference: what the loop above
    # computed)
    fused_err, n_flips = 0.0, 0
    for i in range(T - 2, 0, -1):
        name = f"slice {i}"
        nxt = cases[T - 1 - i][1][0]
        got = solve.backward_slice(nxt, i, *scene)
        torch.cuda.synchronize()
        want, ties = plain[name]
        err, flips = check_close(got, want, "fused " + name)
        if bool(torch.any(flips & ~ties)):
            raise AssertionError(f"fused {name}: {int((flips & ~ties).sum())}"
                                 " non-tie cells pick another action")
        fused_err = max(fused_err, err)
        n_flips += int(flips.sum())
        print(f"fused slice check {name}: max|kernel-plain| = {err:.3e}, "
              f"bit-equal {bool(torch.equal(got, want))}, differing picks "
              f"{int(flips.sum())}")
    if n_flips > MAX_TIE_SHARE * (T - 2) * S * DS * L:
        raise AssertionError(f"fused slices: {n_flips} cells pick another "
                             "action")

    # times: through the bare launcher into a buffer made once and through
    # the wrapper, at the demo grid and at two smaller ones; an empty kernel
    # of the same launch shape; other tile heights
    lib = lam._kernel()
    stream = torch.cuda.current_stream(dev).cuda_stream
    args, tb = cases[1][1], cases[1][2]
    grids = [(f"slice {T - 2} at S={S} DS={DS} L={L}", args, tb)]
    for small in ((61, 9, 11), (37, 5, 3)):
        a, t = seeded_slice(lam, tllk, dev, rng, *small)
        grids.append(("seeded at S={} DS={} L={}".format(*small), a, t))
    for what, a, t in grids:
        out = torch.empty_like(a[0])
        call = action_min_call(a, t, stream)
        times = launcher_times(
            "latlon_action_min", what,
            lambda: call(lib.latlon_action_min, out),
            lambda: lam.action_min(*a, t), 200)
        if a is args:
            ms, wrapper_ms = times
    rows = lib.latlon_action_min_tile_rows(L)
    blocks, threads = -(-S // rows) * DS, -(-rows * L // 32) * 32
    shapes = [(blocks, threads), (-(-S * DS * L // 256), 256)]
    empty = [cuda_ms(lambda: lib.latlon_empty_launch(b, t, stream), 200)
             for b, t in shapes]
    print("empty kernel: " + ", ".join(
        f"{b} blocks of {t} threads {e:.4f} ms"
        for (b, t), e in zip(shapes, empty)))
    out = torch.empty_like(args[0])
    sweep = []
    for ts_rows in (3, 6, 8, 9, 12, 15, 24):
        call = action_min_call(args, tb, stream, ts_rows)
        sweep.append((ts_rows, cuda_ms(
            lambda: call(lib.latlon_action_min_tiled, out), 200)))
        if not torch.equal(out, lam.action_min(*args, tb)):
            raise AssertionError(f"tile of {ts_rows} rows: another result")
    print(f"latlon_action_min by tile height (default {rows}), ms: "
          + ", ".join(f"{r} rows {m:.4f}" for r, m in sweep))
    plain_ms = cuda_ms(lambda: lam.action_min_reference(*args, tb), 20)
    print(f"action_min at S={S} DS={DS} L={L}: kernel {ms:.4f} ms (bare "
          f"launcher; wrapper {wrapper_ms:.4f}), plain {plain_ms:.4f} ms")
    table_ptrs = (ctypes.c_void_p * len(lam.TABLE_KEYS))(*tables.ptrs)

    def fused_call(i, batch_entry=True):
        # one scenario; a source from before the scenario batch takes no
        # B and no distance-map stride
        batch = (1, S * L) if batch_entry else ()
        return lambda fn, out: fn(
            cases[T - 1 - i][1][0].data_ptr(), dist_x[i].data_ptr(),
            rl_t.data_ptr(), step_t.data_ptr(),
            tables.slice_consts.data_ptr(), table_ptrs, out.data_ptr(), S, DS,
            L, rl_t.shape[0], i, *batch, stream)

    for csrc in parents_with(parent_csrc, "latlon_action_min"):
        compare_with_parent(
            "latlon_action_min", lib.latlon_action_min, csrc,
            [(what, a[0], action_min_call(a, t, stream))
             for what, a, t in [("seeded", seeded, tables)] + grids], n=200)
        # the fused slice on the 8 real slices
        batch_entry = slice_takes_batch(csrc)
        compare_with_parent(
            "latlon_action_min", lib.latlon_backward_slice, csrc,
            [(f"fused slice {i}", cases[T - 1 - i][1][0], fused_call(i),
              fused_call(i, batch_entry)) for i in range(T - 2, 0, -1)],
            n=200, argtypes=None if batch_entry else OLD_SLICE_ARGTYPES)

    # the fused slice: bare launcher and wrapper at slice T - 2, its plain
    # version (the producers as tensor operations, then the plain
    # action-min) and the path it replaces (the producers as tensor
    # operations, then the action-min kernel)
    i = T - 2
    nxt = cases[1][1][0]
    out = torch.empty_like(nxt)
    fused_ms, fused_wrapper_ms = launcher_times(
        "latlon_backward_slice", f"slice {i} at S={S} DS={DS} L={L}",
        lambda: lib.latlon_backward_slice(
            nxt.data_ptr(), dist_x[i].data_ptr(), rl_t.data_ptr(),
            step_t.data_ptr(), tables.slice_consts.data_ptr(), table_ptrs,
            out.data_ptr(), S, DS, L, rl_t.shape[0], i, 1, S * L, stream),
        lambda: solve.backward_slice(nxt, i, *scene), 200)
    fused_plain_ms = cuda_ms(
        lambda: solve.backward_slice_reference(nxt, i, *scene), 10)
    unfused_ms = cuda_ms(lambda: lam.action_min(
        nxt, *solve.slice_inputs(i, dist_x, rl_t, step_t, pp), tables), 20)
    print(f"backward slice at S={S} DS={DS} L={L}: fused kernel "
          f"{fused_ms:.4f} ms (bare launcher; wrapper "
          f"{fused_wrapper_ms:.4f}), producers as tensor operations + "
          f"action-min kernel {unfused_ms:.4f} ms, plain {fused_plain_ms:.4f}"
          " ms")

    # kernel launches of one solve (torch.profiler), and of its backward
    # pass with and without the fusion
    x0 = np.zeros(12, np.float32)
    x0[tllk.C_DS] = 9.0

    def backward(step):
        node = solve.final_slice(dist_x, rl_t, step_t, pp)
        for k in range(T - 2, 0, -1):
            node = step(node, k)
        return node

    def fused():
        return backward(lambda node, k: solve.backward_slice(node, k, *scene))

    def unfused():
        return backward(lambda node, k: lam.action_min(
            node, *solve.slice_inputs(k, dist_x, rl_t, step_t, pp), tables))

    def whole():
        return solve(dist, rl, 0.5, p.packed(), x0)

    n_fused, n_unfused = count_launches(fused), count_launches(unfused)
    n_solve = count_launches(whole)
    walls = [wall_ms(f, 5) for f in (unfused, fused, fused, unfused, whole)]
    print("host wall ms ending in a synchronize (mean of 5): the backward "
          "pass with the producers as tensor operations {:.2f}, fused {:.2f},"
          " fused {:.2f}, tensor operations {:.2f}; one whole solve {:.2f}"
          .format(*walls))
    print(f"kernel launches (torch.profiler): the backward pass of one solve "
          f"({T - 2} slices after the final one) {n_unfused} with the "
          f"producers as tensor operations, {n_fused} fused; one whole solve "
          f"{n_solve} (before the fusion {n_solve - n_fused + n_unfused})")
    return dict(err=max_err, ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                fused=dict(err=fused_err, ms=fused_ms,
                           wrapper_ms=fused_wrapper_ms,
                           plain_ms=fused_plain_ms))


def wall_ms(fn, n):
    """Mean host time of fn() over n runs after one, each ending in a
    synchronize."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def count_launches(fn):
    """Device kernels and copies that one call of ``fn`` launches, by
    torch.profiler (after one warm call)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)


def slice_phase(lam, tllk):
    import torch
    import tpl_tpu_torch
    from tpl_tpu_torch.application import EnvironmentApp, PlanningApp
    from tpl_tpu_torch.application.environment_app import load_env_params
    from tpl_tpu_torch.environment import DynamicObject, load_map_store
    from tpl_tpu_torch.scenario_world import ScenarioWorld, SliceStack

    apps = dict(EnvironmentApp=EnvironmentApp, PlanningApp=PlanningApp,
                DynamicObject=DynamicObject, load_env_params=load_env_params,
                load_map_store=load_map_store)
    stack = SliceStack(apps, ScenarioWorld("demo/country_follow"), "smoke")
    planner = stack.planner
    cpp = planner.shared.params.planner.cpp
    spec = {k: getattr(cpp, k) for k in DEMO_SPEC}
    if spec != DEMO_SPEC:
        raise AssertionError(f"demo param set grid {spec} != {DEMO_SPEC}")

    last = planner.policy.last_replan_time
    replans, replan_ms = 0, []
    lam.launches = lam.slice_launches = 0
    for k in range(MAX_TICKS):
        t0 = time.perf_counter()
        traj = stack.step(round(k * TICK, 5))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        if planner.policy.last_replan_time != last:
            last = planner.policy.last_replan_time
            replans += 1
            replan_ms.append(wall)
        cols = (traj.time, traj.x, traj.y, traj.orientation,
                traj.curvature, traj.velocity, traj.acceleration)
        if traj.emergency:
            raise AssertionError(f"tick {k}: emergency trajectory")
        if not all(np.all(np.isfinite(c)) for c in cols):
            raise AssertionError(f"tick {k}: non-finite trajectory")
        if replans >= MIN_REPLANS:
            break
    launches = lam.launches
    print(f"slice: {k + 1} ticks, {replans} replans, kernel launches "
          f"{launches} ({lam.slice_launches} of the fused slice kernel)")
    if replans < MIN_REPLANS:
        raise AssertionError(f"only {replans} replans")
    if not launches == lam.slice_launches == (spec["t_steps"] - 2) * replans:
        raise AssertionError(f"{launches} launches for {replans} replans")
    print("per-replan wall ms: " + ", ".join(f"{m:.2f}" for m in replan_ms)
          + f" (median {np.median(replan_ms):.2f})")

    # the last replan's solve, re-run on the same grid by the plain
    # version on the CPU
    grid = planner.dp_env.cpp_env.grid
    ppv = cpp.packed()
    x0 = planner.traj_dp[0].astype(np.float32)
    solve_gpu, _ = tllk.make_latlon_solver(spec, tpl_tpu_torch.device())
    solve_cpu, _ = tllk.make_latlon_solver(spec, "cpu")
    ref_step = np.float32(planner.dp_env.cpp_env.ref_step)
    n_g, tr_g = solve_gpu(grid.dist_map_lon, grid.ref_line, ref_step, ppv, x0)
    n_c, tr_c = solve_cpu(grid.dist_map_lon.cpu(), grid.ref_line.cpu(),
                          ref_step, ppv, x0)
    np.testing.assert_allclose(n_g[..., 0].cpu(), n_c[..., 0],
                               rtol=COST_RTOL, atol=COST_ATOL)
    np.testing.assert_allclose(tr_g.cpu(), tr_c, rtol=COST_RTOL,
                               atol=TRAJ_ATOL)
    print("slice: last solve matches the plain version on the CPU "
          f"(max traj diff {float((tr_g.cpu() - tr_c).abs().max()):.3e})")


def mpc_setup_inputs(itm, max_iterations):
    """The packed inputs and launch arguments of ``__graft_entry__.py``'s
    ``_mpc_setup`` (its numbers, copied: that module imports JAX)."""
    from tpl_tpu_torch.optim import ilqr

    ss = np.arange(128) * 0.5
    ref_y = 2.0 * np.sin(ss * 0.1)
    phi = np.arctan(np.gradient(ref_y, ss))
    params = {
        "pd": 10.0, "pv": 5.0, "pdelta": 0.0, "min_pdelta_dot": 0.1,
        "pdelta_dot": 0.0, "min_p_phi_dot": 0.0, "p_phi_dot": 0.0,
        "p_phi": 0.01, "p_phi_ref_dot_diff": 0.01, "pa": 2.0, "pj": 0.5,
        "l": 3.165, "v_ch": 32.0,
        "ref_x": ss, "ref_y": ref_y, "ref_phi": phi,
        "ref_k": np.gradient(phi, ss), "ref_v": np.full(128, 8.0),
        "ref_step": 0.5, "max_delta": 0.7, "max_acc": 3.0,
        "min_acc": -3.0, "a_offset": 0.0}
    x = np.zeros((MPC_H + 1, 7))
    x[0] = [0.0, 1.0, 0.0, 0.0, 5.0, 0.0, 0.0]
    inputs = dict(
        x=x, u=np.zeros((MPC_H, 2)), lam=np.zeros((MPC_H, 4)),
        u_lims=np.tile(np.array([[[-3.0, 1.5], [-1.0, 1.0]]]), (MPC_H, 1, 1)),
        bw_lim=np.stack([np.full(4, 1e4), np.full(4, 1e30)], -1),
        cfg_f=np.array([0.05, 1e-6]))
    args = (MPC_H, 128, MPC_H, max_iterations, 1, 0, ilqr.HEUN)
    return itm.pack_inputs(inputs, params), args


def compare_solves(itm, got, want, H, what):
    """Kernel vs plain results: raises beyond the tolerances; returns
    (max |x|, |u| difference, cost relative difference)."""
    a = itm.unpack_outputs(got.cpu().numpy(), H)
    b = itm.unpack_outputs(want.cpu().numpy(), H)
    dx = float(np.max(np.abs(a["x"] - b["x"])))
    du = float(np.max(np.abs(a["u"] - b["u"])))
    dlam = float(np.max(np.abs(a["lam"] - b["lam"])))
    dcost = abs(a["traj_costs"] - b["traj_costs"]) / max(
        abs(b["traj_costs"]), 1e-300)
    print(f"ilqr check {what}: max|dx| {dx:.3e}, max|du| {du:.3e}, "
          f"max|dlam| {dlam:.3e}, cost rel {dcost:.3e}, mu_step "
          f"{a['mu_step']}/{b['mu_step']}, iterations "
          f"{a['iterations']}/{b['iterations']}")
    if max(dx, du, dlam) > MPC_X_ATOL or not dcost <= MPC_COST_RTOL:
        raise AssertionError(f"{what}: kernel and plain solves differ")
    if (a["mu_step"], a["iterations"]) != (b["mu_step"], b["iterations"]):
        raise AssertionError(f"{what}: mu_step / iterations differ")
    if not np.all(np.isfinite(a["x"])):
        raise AssertionError(f"{what}: non-finite solve")
    return max(dx, du), dcost


def closed_loop_phase(lam, itm):
    """SimStandalone with the DP planner and the tracking MPC on the card;
    records 3 warm-started solves and the last one for the iLQR phase."""
    import torch
    from tpl_tpu_torch.simulation import SimStandalone

    sim = SimStandalone(app_id="smoke_loop",
                        scenario_path="demo/country_follow")
    store = sim.planning_app.sh_planners
    with store.lock():
        store.active_planner = "dp_lat_lon_planner"
        cpp = store.dp_lat_lon_planner.params.planner.cpp
    spec = {k: getattr(cpp, k) for k in DEMO_SPEC}
    if spec != DEMO_SPEC:
        raise AssertionError(f"demo param set grid {spec} != {DEMO_SPEC}")
    planner = sim.planning_app.planners["dp_lat_lon_planner"]
    controllers = sim.control_app.sh_controllers
    with controllers.lock():
        active = controllers.active_controller
        mp = controllers.model_predictive_controller.params
        mpc_cfg = (mp.horizon, mp.max_iterations)
    if active != "model_predictive_controller" or mpc_cfg != (MPC_H, 20):
        raise AssertionError(f"control set: {active} {mpc_cfg}")
    mpc = sim.control_app.controllers["model_predictive_controller"]
    with sim.core.sh_state.lock():
        ss = sim.core.sh_state.sim
        ss.settings.running = True
        ss.settings.use_real_time = False
        ss.rule_checker.enable = True

    # keep copies of some solves' packed inputs and time each solve on the
    # card (these are the loop's own launches: the wrapper is called as the
    # controller calls it)
    solve = itm.update
    rec = {"n": 0, "picked": [], "last": None, "events": []}

    def recording(buf, *args):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = solve(buf, *args)
        ev[1].record()
        rec["events"].append(ev)
        if rec["n"] in RECORD_SOLVES:
            rec["picked"].append((rec["n"], buf.clone(), args))
        rec["last"] = (buf.clone(), args, out.clone())
        rec["n"] += 1
        return out

    itm.update = recording
    try:
        last_replan = planner.policy.last_replan_time
        tick_ms, control_ms, replan_ms, iterations = [], [], [], []
        solves0 = mpc.opt.updates
        lam.launches = lam.slice_launches = 0
        itm.launches = 0
        for k in range(DP_TICKS):
            t0 = time.perf_counter()
            sim.update()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            tick_ms.append(wall)
            if mpc.opt.updates - solves0 > len(iterations):
                iterations.append(mpc.opt.iterations)
            with controllers.lock():
                control_ms.append(controllers.runtime * 1e3)
                controls = np.array(controllers.controls)
            with store.lock():
                emergency = store.trajectory.emergency
            if planner.policy.last_replan_time != last_replan:
                last_replan = planner.policy.last_replan_time
                replan_ms.append(wall)
            if emergency:
                raise AssertionError(f"tick {k}: emergency trajectory")
            if not np.all(np.isfinite(controls)):
                raise AssertionError(f"tick {k}: non-finite controls")
        am_launches, ilqr_launches = lam.launches, itm.launches
        slice_launches = lam.slice_launches
        solves = mpc.opt.updates - solves0
    finally:
        itm.update = solve

    with sim.core.sh_state.lock():
        s = sim.core.sh_state.sim
        violations = list(s.rule_checker.violations)
        t_end, x_end, v_end = s.t, s.ego.x, s.ego.v
    print(f"closed loop: {DP_TICKS} ticks to t={t_end:.2f} s, ego x "
          f"{x_end:.2f} v {v_end:.2f} m/s, {len(violations)} violations, "
          f"{len(replan_ms)} replans, {solves} MPC solves; launches: "
          f"latlon_action_min {am_launches} (all {slice_launches} through "
          f"the fused slice kernel), ilqr_tracking_mpc {ilqr_launches}")
    if violations:
        raise AssertionError(f"rule violations: {violations[:3]}")
    if not v_end > 4.0:
        raise AssertionError(f"ego speed {v_end} at the end")
    if not am_launches == slice_launches == (
            spec["t_steps"] - 2) * len(replan_ms):
        raise AssertionError(f"{am_launches} action-min launches for "
                             f"{len(replan_ms)} replans")
    if solves < DP_TICKS - 5 or ilqr_launches != solves:
        raise AssertionError(f"{ilqr_launches} iLQR launches for {solves} "
                             "controller solves")
    print(f"per-tick control wall ms: median {np.median(control_ms):.3f}, "
          f"max {np.max(control_ms):.3f}; per-tick total wall ms: median "
          f"{np.median(tick_ms):.3f}, max {np.max(tick_ms):.3f}; per-replan "
          f"wall ms: median {np.median(replan_ms):.3f} (first "
          f"{replan_ms[0]:.3f}, max {np.max(replan_ms):.3f})")
    solve_ms = [a.elapsed_time(b) for a, b in rec["events"]]
    print(f"MPC solve on the card (CUDA events) ms: median "
          f"{np.median(solve_ms):.4f}, max {np.max(solve_ms):.4f}; "
          f"iterations per solve: median {np.median(iterations):.1f}, max "
          f"{np.max(iterations)}")

    # the last tick's solve, re-run by the plain version on the CPU
    buf, args, out = rec["last"]
    err, _ = compare_solves(itm, out, itm.update_reference(buf.cpu(), *args),
                            MPC_H, "last loop solve vs plain on the CPU")
    return dict(am_launches=am_launches, slice_launches=slice_launches,
                ilqr_launches=ilqr_launches,
                replans=len(replan_ms), picked=rec["picked"], err=err,
                first_replan_ms=replan_ms[0])


def dp_first_replan_child(csrc):
    """In a fresh process: binds the kernel libraries of the DP loop as
    this script's start does (``latlon_action_min`` from ``csrc`` where
    given, else the tree's, which loads its code when bound), then drives
    the DP loop on demo/country_follow to its first replan and prints
    {"first_replan_ms": the planner's runtime_dp} as the last line."""
    import torch
    import tpl_tpu_torch
    from tpl_tpu_torch import _build
    from tpl_tpu_torch.optim import ilqr_tracking_mpc as itm
    from tpl_tpu_torch.planning.dyn_prog import latlon_action_min as lam
    from tpl_tpu_torch.simulation import SimStandalone

    tpl_tpu_torch.use_device("cuda")
    if csrc:
        lib = _build.load("latlon_action_min", csrc)
        if not hasattr(lib, "latlon_action_min_prepare"):
            # a source that loads its code at the first launch
            lib.latlon_action_min_prepare = lambda: 0
        if not slice_takes_batch(csrc):
            # a source from before the scenario batch: its slice entry
            # takes no B and no distance-map stride
            old = lib.latlon_backward_slice
            old.restype, old.argtypes = ctypes.c_int, OLD_SLICE_ARGTYPES
            lib.latlon_backward_slice = lambda *a: old(*a[:12], a[-1])
        if not hasattr(lib, "latlon_backward_slice_grid"):
            # a source from before the persistent batch: the wrapper's
            # check of a launch's blocks from its tile, and the profiling
            # and attribute entries, which the loop never calls
            rows = lib.latlon_action_min_tile_rows
            rows.restype, rows.argtypes = ctypes.c_int, [ctypes.c_int]
            lib.latlon_backward_slice_grid = lambda S, DS, L, B: (
                -(-S // rows(L)) * DS * B if rows(L) > 0 else -1)
            lib.latlon_backward_slice_n_phases = lambda: len(lam.SLICE_PHASES)
            lib.latlon_backward_slice_profile = lambda *a: 1
            lib.latlon_backward_slice_attributes = lambda *a: 1
        load = _build.load
        _build.load = lambda name, c=None: (
            lib if name == "latlon_action_min" else load(name, c))
    lam._kernel()
    itm._kernel()
    sim = SimStandalone(app_id="smoke_first_replan",
                        scenario_path="demo/country_follow")
    store = sim.planning_app.sh_planners
    with store.lock():
        store.active_planner = "dp_lat_lon_planner"
    planner = sim.planning_app.planners["dp_lat_lon_planner"]
    with sim.core.sh_state.lock():
        ss = sim.core.sh_state.sim
        ss.settings.running = True
        ss.settings.use_real_time = False
    last = planner.policy.last_replan_time
    for _ in range(20):
        sim.update()
        torch.cuda.synchronize()
        if planner.policy.last_replan_time != last:
            break
    else:
        raise AssertionError("no replan in 20 ticks")
    print(json.dumps({"first_replan_ms": planner.runtime_dp}))


def dp_first_replan_phase(parent_csrc):
    """With a parent ``latlon_action_min.cu``: the DP loop's first replan
    (the planner's runtime_dp) in four fresh processes, the parent's source
    and the tree's in turns (parent, tree, tree, parent), each binding the
    libraries before the loop starts (:func:`dp_first_replan_child`).
    Returns {"parent": [ms, ms], "tree": [ms, ms]}, or None without a
    parent."""
    import subprocess

    parents = parents_with(parent_csrc, "latlon_action_min")
    if not parents:
        return None
    out = {"parent": [], "tree": []}
    for who in ("parent", "tree", "tree", "parent"):
        arg = os.path.abspath(parents[0]) if who == "parent" else ""
        done = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--dp-first-replan",
             arg], capture_output=True, text=True, timeout=300)
        if done.returncode != 0:
            raise AssertionError(f"DP first replan ({who}) failed:\n"
                                 + done.stderr[-3000:])
        out[who].append(json.loads(
            done.stdout.strip().splitlines()[-1])["first_replan_ms"])
    print(f"latlon_action_min: the DP loop's first replan in a fresh process "
          f"with the libraries bound before it (runtime_dp ms): parent "
          f"{out['parent'][0]:.3f}, tree {out['tree'][0]:.3f}, tree "
          f"{out['tree'][1]:.3f}, parent {out['parent'][1]:.3f} (the tree "
          f"loads its code when bound, the parent at its first launch)")
    return out


def graph_ms(launch, n=50, reps=10):
    """Mean device ms per launch of ``launch(stream)`` (it launches one
    kernel on the CUDA stream handle ``stream``), replayed from a CUDA graph
    of ``n`` launches, so that the host's launch rate does not bound a
    short kernel."""
    import torch

    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        launch(side.cuda_stream)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        stream = torch.cuda.current_stream().cuda_stream
        for _ in range(n):
            launch(stream)
    g.replay()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        g.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (n * reps)


def in_turns(old, new, n):
    """Mean ms of old() and new() by CUDA events, run old, new, new, old;
    returns ((old ms, old ms), (new ms, new ms))."""
    a = cuda_ms(old, n)
    b = cuda_ms(new, n)
    c = cuda_ms(new, n)
    d = cuda_ms(old, n)
    return (a, d), (b, c)


# the fused slice entry of a latlon_action_min.cu from before the scenario
# batch (no B, no distance-map stride)
OLD_SLICE_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
    ctypes.c_void_p]


def slice_takes_batch(csrc):
    """Whether ``latlon_action_min.cu`` in ``csrc`` has the fused slice
    entry that takes a scenario batch (B and the distance-map stride)."""
    with open(os.path.join(csrc, "latlon_action_min.cu")) as f:
        return "long long dist_stride, void* stream" in f.read()


def parents_with(dirs, source):
    """The directories of ``dirs`` (may be None) that hold ``<source>.cu``."""
    return [d for d in dirs or ()
            if os.path.isfile(os.path.join(d, source + ".cu"))]


def compare_with_parent(source, lib_fn, csrc, cases, n=30, times=None,
                        argtypes=None):
    """Holds the tree's launcher ``lib_fn`` of ``<source>.cu`` against the
    same launcher of another version of that source, built from the
    directory ``csrc`` with the port's flags.  ``cases`` are (what, like,
    call) or (what, like, call, parent_call): ``call(fn, out)`` launches
    ``fn`` into ``out`` (a tensor like ``like``) and returns the CUDA error
    code; ``parent_call`` does so for a parent whose launcher reads its
    arguments another way.  Both go through the bare launcher into
    buffers made once, so that the wrapper's host work is in neither time.
    Prints the largest difference of the results and the times in turns
    (into ``times[what]`` as (parent, new, new, parent) ms where given);
    ``argtypes``, where given, are the parent launcher's (else the tree's).
    Returns the parent's library."""
    import torch
    from tpl_tpu_torch import _build

    parent_lib = _build.load(source, csrc)
    parent = getattr(parent_lib, lib_fn.__name__)
    parent.restype = lib_fn.restype
    parent.argtypes = argtypes or lib_fn.argtypes
    fns = (parent, lib_fn)
    for what, like, *calls in cases:
        outs = [torch.empty_like(like) for _ in fns]

        def launch(i):
            err = calls[-1 if i == 0 else 0](fns[i], outs[i])
            if err:
                raise RuntimeError(f"launch failed: CUDA error {err}")

        launch(0), launch(1)
        torch.cuda.synchronize()
        diff = 0.0 if torch.equal(outs[0], outs[1]) else float(
            (outs[1] - outs[0]).abs().nan_to_num(float("inf")).max())
        (a, d), (b, c) = in_turns(lambda: launch(0), lambda: launch(1), n)
        print(f"{source} {what} vs the source in {csrc}: max |new - parent| "
              f"{diff:.3e}; ms per launch parent {a:.4f}, new {b:.4f}, new "
              f"{c:.4f}, parent {d:.4f}")
        if times is not None:
            times[what] = (a, b, c, d)
        if not diff == 0.0 and source in ("rstp_rampify", "latlon_action_min",
                                          "idm_rollout", "idm_evaluate",
                                          "ilqr_tracking_mpc",
                                          "ilqr_tracking_mpc_time",
                                          "lon_dp", "dir_dist_map",
                                          "poly_planner"):
            raise AssertionError(f"{source} {what}: the result differs from "
                                 "the parent kernel's")
    return parent_lib


def launcher_times(name, what, bare, wrapper, n):
    """A kernel through its bare launcher (``bare()`` launches into buffers
    made once and returns the CUDA error code) and through its Python
    wrapper, in turns; prints the four times side by side and returns
    (bare ms, wrapper ms), each the mean of its two."""
    def checked():
        err = bare()
        if err:
            raise RuntimeError(f"{name} launch failed: CUDA error {err}")

    (a, d), (b, c) = in_turns(checked, wrapper, n)
    print(f"{name} {what}: ms per launch through the bare launcher {a:.4f}, "
          f"the wrapper {b:.4f}, the wrapper {c:.4f}, the bare launcher "
          f"{d:.4f}")
    return (a + d) / 2, (b + c) / 2


def ilqr_phase(itm, picked, dev, mhz, parent_csrc=None):
    """The iLQR kernel against the plain make_update_fn on the card, its
    profiling instantiation, and (with ``parent_csrc``) against another
    version of its source."""
    import torch
    from tpl_tpu_torch.optim import ilqr

    cases = []
    for it in (8, 20):
        host, args = mpc_setup_inputs(itm, it)
        cases.append((f"_mpc_setup {it} it", torch.from_numpy(host).to(dev),
                      args))
    if len(picked) != len(RECORD_SOLVES):
        raise AssertionError(f"recorded {len(picked)} loop solves")
    cases += [(f"loop solve {n}", buf, args) for n, buf, args in picked]
    max_err = 0.0
    for what, buf, args in cases:
        got = itm.update(buf, *args)
        want = itm.update_reference(buf, *args)
        torch.cuda.synchronize()
        err, _ = compare_solves(itm, got, want, MPC_H, what)
        max_err = max(max_err, err)

    # the profiling instantiation: the same bits, and the cycles per phase
    single_us = None
    for what, buf, args in cases[:3]:
        got = itm.update(buf, *args)
        prof, cycles = itm.profile(buf, *args)
        torch.cuda.synchronize()
        if not torch.equal(got, prof):
            raise AssertionError(f"{what}: the profiling instantiation's "
                                 "result differs")
        its = itm.unpack_outputs(got.cpu().numpy(), MPC_H)["iterations"]
        us = phase_line("ilqr_tracking_mpc", what, ilqr, cycles, its, mhz)
        single_us = us if single_us is None else single_us

    times = {}
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib_fn = itm._kernel().ilqr_tracking_mpc
    for what, buf, args in cases[:2]:
        out = torch.empty_like(itm.update(buf, *args))
        ms, wrapper_ms = launcher_times(
            "ilqr_tracking_mpc", what,
            lambda: lib_fn(buf.data_ptr(), out.data_ptr(), *args, stream),
            lambda: itm.update(buf, *args), 50)
        plain_ms = cuda_ms(lambda: itm.update_reference(buf, *args), 2)
        times[what] = (ms, wrapper_ms, plain_ms)
        print(f"ilqr_tracking_mpc {what} at H={MPC_H}: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms per solve")

    # the single solve and its profiling instantiation against another
    # version's: the same bits (a difference raises), times in turns
    cyc = torch.zeros(len(ilqr.PHASES), dtype=torch.int64, device=dev)
    for csrc in parents_with(parent_csrc, "ilqr_tracking_mpc"):
        compare_with_parent(
            "ilqr_tracking_mpc", itm._kernel().ilqr_tracking_mpc, csrc,
            [(what, itm.update(buf, *args),
              lambda fn, out, buf=buf, args=args: fn(
                  buf.data_ptr(), out.data_ptr(), *args, stream))
             for what, buf, args in cases])
        compare_with_parent(
            "ilqr_tracking_mpc", itm._kernel().ilqr_tracking_mpc_profile,
            csrc,
            [(what + " (profile)", itm.update(buf, *args),
              lambda fn, out, buf=buf, args=args: fn(
                  buf.data_ptr(), out.data_ptr(), cyc.data_ptr(), *args,
                  stream))
             for what, buf, args in cases[:2]])
    _, buf, args = cases[1]
    its = itm.unpack_outputs(itm.update(buf, *args).cpu().numpy(),
                             MPC_H)["iterations"]
    return max_err, times[cases[1][0]], its, single_us


def _to(tree, dev):
    """A fused-step carry (dict of tensors, solver states, host values)
    moved to ``dev``."""
    import torch
    from tpl_tpu_torch.optim import ilqr

    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    if isinstance(tree, ilqr.SolverState):
        return ilqr.SolverState(*(_to(a, dev) for a in (
            tree.x, tree.u, tree.lam, tree.mu_step)))
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree


def check_planning_set(scenario, active, params, smooth_only=False):
    """Raises unless the RSTP planner is active with the vendored set:
    fused, H=RSTP_H, and ``smooth_only`` off, or on where the caller (the
    smooth_only phase) has turned it on."""
    cfg = (params.use_fused, params.horizon, params.smooth_only)
    if active != "path_vel_decomp_planner" or cfg != (True, RSTP_H,
                                                      smooth_only):
        raise AssertionError(f"planning set of {scenario}: {active} {cfg}")


def rstp_loop_phase(rstp, rmp, itm, scenario, ticks, screen=True,
                    record=False):
    """SimStandalone with the scenario's own param sets (the RSTP planner,
    fused, and the tracking MPC) on the card.  Checks the loop and the
    launch counts; re-runs the last fused step on the CPU.  With
    ``record``, keeps the first cold and 3 warm solves of each RSTP problem
    and two rampify calls for the kernel phase."""
    import torch
    from tpl_tpu_torch.planning.path_vel_decomp import fused_replan
    from tpl_tpu_torch.simulation import SimStandalone

    name = scenario.split("/")[-1]
    sim = SimStandalone(app_id=f"smoke_{name}", scenario_path=scenario)
    store = sim.planning_app.sh_planners
    with store.lock():
        params = store.path_vel_decomp_planner.params
        check_planning_set(scenario, store.active_planner, params)
        params.collision_screen = screen
    planner = sim.planning_app.planners["path_vel_decomp_planner"]
    controllers = sim.control_app.sh_controllers
    with controllers.lock():
        active = controllers.active_controller
        mp = controllers.model_predictive_controller.params
        mpc_cfg = (mp.horizon, mp.max_iterations)
    if active != "model_predictive_controller" or mpc_cfg != (MPC_H, 20):
        raise AssertionError(f"control set: {active} {mpc_cfg}")
    mpc = sim.control_app.controllers["model_predictive_controller"]
    with sim.core.sh_state.lock():
        ss = sim.core.sh_state.sim
        ss.settings.running = True
        ss.settings.use_real_time = False
        ss.rule_checker.enable = True

    # the loop's own launches, recorded as the planner makes them
    solve, scan = rstp.update, rmp.scan
    rec = {"n": {}, "picked": [], "scans": [], "events": []}

    def recording(pname, buf, *args):
        n = rec["n"].get(pname, 0)
        rec["n"][pname] = n + 1
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = solve(pname, buf, *args)
        ev[1].record()
        rec["events"].append((pname, ev))
        if record and (n == 0 or n in RECORD_REPLANS):
            rec["picked"].append((f"{pname} solve {n}", pname, buf.clone(),
                                  args))
        return out

    def recording_scan(*args):
        if record and len(rec["scans"]) < 2 and (
                not rec["scans"] or planner.fused.steps >= 100):
            rec["scans"].append(tuple(a.clone() if torch.is_tensor(a) else a
                                      for a in args))
        return scan(*args)

    last = {}

    def recording_step(step):
        def run(carry, inp):
            last.update(carry=carry, inp=inp)
            carry, out = step(carry, inp)
            last["out"] = out
            return carry, out
        return run

    rstp.update, rmp.scan = recording, recording_scan
    try:
        tick_ms, plan_ms, control_ms, its, emergency = [], [], [], [], []
        leaders = 0
        solves0 = mpc.opt.updates
        rstp.launches = rmp.launches = itm.launches = 0
        for k in range(ticks):
            t0 = time.perf_counter()
            sim.update()
            torch.cuda.synchronize()
            tick_ms.append((time.perf_counter() - t0) * 1e3)
            fused = planner.fused
            if fused is not None and "wrapped" not in last:
                fused._step = recording_step(fused._step)
                last["wrapped"] = True
            with store.lock():
                plan_ms.append(store.runtime * 1e3)
                traj = store.trajectory
            with controllers.lock():
                control_ms.append(controllers.runtime * 1e3)
                controls = np.array(controllers.controls)
            if fused is not None:
                its.append(fused.iterations)
                leaders += planner.velocity_optim.s_leader < 1e5
                # a published plan of the planner's own, screened or not
                # (an unknown planner publishes an empty emergency plan)
                if len(traj.x) != fused.H or not np.all(
                        np.isfinite(traj.velocity)):
                    raise AssertionError(f"{name} tick {k}: no finite plan")
            if traj.emergency:
                emergency.append(k)
            if not np.all(np.isfinite(controls)):
                raise AssertionError(f"{name} tick {k}: non-finite controls")
        launches = dict(ilqr_rstp=rstp.launches, rstp_rampify=rmp.launches,
                        ilqr_tracking_mpc=itm.launches)
        solves = mpc.opt.updates - solves0
    finally:
        rstp.update, rmp.scan = solve, scan

    replans = planner.fused.steps
    with sim.core.sh_state.lock():
        s = sim.core.sh_state.sim
        violations = list(s.rule_checker.violations)
        t_end, x_end, v_end = s.t, s.ego.x, s.ego.v
    window = f"ticks {emergency[0]}-{emergency[-1]}" if emergency else "none"
    print(f"rstp {name}: {ticks} ticks to t={t_end:.2f} s, ego x {x_end:.2f} "
          f"v {v_end:.2f} m/s, {len(violations)} violations, {replans} "
          f"replans ({leaders} with a leader), {solves} MPC solves, "
          f"{len(emergency)} emergency ticks ({window}); launches: "
          f"{launches}")
    if violations:
        raise AssertionError(f"rule violations: {violations[:3]}")
    # the collision screen may latch the hard brake for screen_hold_time
    # (on country_follow the JAX package's loop does so from t=0.04 s on,
    # when the leader is first seen); the run must end out of it
    if not screen and emergency:
        raise AssertionError(f"{name}: emergency with the screen off")
    if emergency and emergency[-1] >= ticks - ticks // 4:
        raise AssertionError(f"{name}: emergency latched at the end")
    if not v_end > 4.0:
        raise AssertionError(f"ego speed {v_end} at the end")
    if replans < ticks - 5:
        raise AssertionError(f"only {replans} replans in {ticks} ticks")
    if (launches["ilqr_rstp"], launches["rstp_rampify"]) != (2 * replans,
                                                             replans):
        raise AssertionError(f"{launches} for {replans} replans")
    # while the hard brake is latched the constant-deceleration controller
    # drives and the MPC does not solve
    if solves < ticks - len(emergency) - 5 \
            or launches["ilqr_tracking_mpc"] != solves:
        raise AssertionError(f"{launches} for {solves} controller solves")
    its = np.array(its)
    print(f"rstp {name} walls ms: per-tick total median "
          f"{np.median(tick_ms):.3f} max {np.max(tick_ms):.3f}; planning "
          f"median {np.median(plan_ms):.3f} max {np.max(plan_ms):.3f}; "
          f"control median {np.median(control_ms):.3f} max "
          f"{np.max(control_ms):.3f}")
    for pname in rstp.PROBLEMS:
        ms = [ev[0].elapsed_time(ev[1]) for p, ev in rec["events"]
              if p == pname]
        col = 0 if pname == "lateral_profile" else 1
        print(f"rstp {name} {pname} in the loop (CUDA events) ms: median "
              f"{np.median(ms):.4f}, max {np.max(ms):.4f}; iterations per "
              f"solve: median {np.median(its[:, col]):.1f}, max "
              f"{np.max(its[:, col])}")

    # the last fused step, re-run on the CPU by the plain versions
    H = planner.fused.H
    step_cpu = fused_replan.make_fused_step(H)
    _, out_cpu = step_cpu(_to(last["carry"], torch.device("cpu")),
                          last["inp"])
    got = fused_replan.unpack_outputs(last["out"].cpu().numpy(), H)
    want = fused_replan.unpack_outputs(out_cpu.numpy(), H)
    T = int(last["inp"]["scal_i"][0])
    d_path = float(np.max(np.abs(got["opt_path"][:T, :2]
                                 - want["opt_path"][:T, :2])))
    d_v = float(np.max(np.abs(got["prof"][:T, 0] - want["prof"][:T, 0])))
    d_lead = np.abs(got["scals"][:2] - want["scals"][:2])
    print(f"rstp {name}: last fused step vs the plain versions on the CPU: "
          f"max|path| {d_path:.3e} m, max|v| {d_v:.3e} m/s, "
          f"s/v_leader diff {d_lead[0]:.3e} / {d_lead[1]:.3e}, iterations "
          f"{got['tails'][:, 2]} / {want['tails'][:, 2]}")
    if not (d_path <= FUSED_PATH_ATOL and d_v <= FUSED_V_ATOL
            and np.all(d_lead <= FUSED_PATH_ATOL)):
        raise AssertionError(f"{name}: the fused step on the card and on "
                             "the CPU differ")
    if name == "country_overtake" and leaders < replans - 5:
        raise AssertionError(f"only {leaders} of {replans} replans with a "
                             "leader")
    return dict(launches=launches, picked=rec["picked"], scans=rec["scans"],
                err=max(d_path, d_v))


def compare_rstp(rstp, got, want, pname, H, what):
    """ilqr_rstp kernel vs plain results: raises beyond the float32
    tolerances; returns (max |x|, |u| difference, cost rel difference)."""
    a = rstp.unpack_outputs(pname, got.cpu().numpy().astype(np.float64), H)
    b = rstp.unpack_outputs(pname, want.cpu().numpy().astype(np.float64), H)
    dx = float(np.max(np.abs(a["x"] - b["x"])))
    du = float(np.max(np.abs(a["u"] - b["u"])))
    dlam = float(np.max(np.abs(a["lam"] - b["lam"])))
    dcost = abs(a["traj_costs"] - b["traj_costs"]) / max(
        abs(b["traj_costs"]), 1e-30)
    print(f"ilqr_rstp check {what}: max|dx| {dx:.3e}, max|du| {du:.3e}, "
          f"max|dlam| {dlam:.3e}, cost rel {dcost:.3e}, mu_step "
          f"{a['mu_step']}/{b['mu_step']}, iterations "
          f"{a['iterations']}/{b['iterations']}")
    if max(dx, du, dlam) > RSTP_X_ATOL or not dcost <= RSTP_COST_RTOL:
        raise AssertionError(f"{what}: kernel and plain solves differ")
    if not np.all(np.isfinite(a["x"])):
        raise AssertionError(f"{what}: non-finite solve")
    return max(dx, du), dcost


def rstp_kernel_phase(rstp, rmp, picked, scans, dev, mhz, parent_csrc=None):
    """Both ilqr_rstp instantiations and rstp_rampify against their plain
    versions on the card, the solves' profiling instantiations, and (with
    ``parent_csrc``) the solves against another version of their source."""
    import torch
    from tpl_tpu_torch.optim import ilqr

    want_n = 2 * (1 + len(RECORD_REPLANS))
    if len(picked) != want_n or len(scans) != 2:
        raise AssertionError(f"recorded {len(picked)} solves, {len(scans)} "
                             "scans")
    max_err = 0.0
    for what, pname, buf, args in picked:
        got = rstp.update(pname, buf, *args)
        want = rstp.update_reference(pname, buf, *args)
        torch.cuda.synchronize()
        err, _ = compare_rstp(rstp, got, want, pname, args[0], what)
        max_err = max(max_err, err)
    # the profiling instantiation: the same bits, and the cycles per phase
    iterations = {}
    for what, pname, buf, args in picked:
        got = rstp.update(pname, buf, *args)
        prof, cycles = rstp.profile(pname, buf, *args)
        torch.cuda.synchronize()
        if not torch.equal(got, prof):
            raise AssertionError(f"{what}: the profiling instantiation's "
                                 "result differs")
        its = rstp.unpack_outputs(pname, got.cpu().numpy(),
                                  args[0])["iterations"]
        iterations.setdefault(pname, its)
        phase_line("ilqr_rstp", what, ilqr, cycles, its, mhz)

    stream = torch.cuda.current_stream(dev).cuda_stream
    for csrc in parents_with(parent_csrc, "ilqr_rstp"):
        compare_with_parent(
            "ilqr_rstp", rstp._kernel().ilqr_rstp_update, csrc,
            [(what, rstp.update(pname, buf, *args),
              lambda fn, out, pid=rstp.PROBLEMS[pname]["id"], buf=buf,
              args=args: fn(pid, buf.data_ptr(), out.data_ptr(), *args,
                            stream))
             for what, pname, buf, args in picked])

    times = {}
    for what, pname, buf, args in picked:
        if pname in times:
            continue        # the first (cold) solve of each problem
        out = torch.empty_like(rstp.update(pname, buf, *args))
        ms, wrapper_ms = launcher_times(
            "ilqr_rstp", what,
            lambda: rstp._kernel().ilqr_rstp_update(
                rstp.PROBLEMS[pname]["id"], buf.data_ptr(), out.data_ptr(),
                *args, stream),
            lambda: rstp.update(pname, buf, *args), 50)
        plain_ms = cuda_ms(lambda: rstp.update_reference(pname, buf, *args),
                           1, warm=1)
        times[pname] = (ms, wrapper_ms, plain_ms)
        print(f"ilqr_rstp {what} at H={args[0]}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms per solve")

    ramp = rampify_phase(rmp, scans, dev, mhz, parent_csrc)
    return dict(ilqr_err=max_err, ilqr_times=times, iterations=iterations,
                shapes={pname: args[:3] for _, pname, _, args in picked[:2]},
                **ramp)


def rampify_phase(rmp, scans, dev, mhz, parent_csrc=None):
    """rstp_rampify against its plain version, bit for bit, on seeded
    inputs and on the loop's recorded calls ``scans`` (may be empty); its
    profiling instantiation; its times through the bare launcher and the
    wrapper; and (with ``parent_csrc``) against another version of its
    source, whose launcher takes the scalars and the limits in one buffer."""
    import ctypes
    import torch

    rng = np.random.default_rng(0)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    lim = np.maximum(1.0, 10.0 + np.cumsum(rng.normal(0, 1.0, RSTP_H)))
    lim[40:45] = 2.0
    seeded = (f32(8.0), f32(0.3), f32(lim), RSTP_H - 30, f32(-2.5),
              f32(2.5), f32(-1.5), f32(1.5), f32(1.0), f32(0.5))
    # a constant limit (cruising): every step resets the acceleration
    flat = (f32(10.0), f32(0.0), f32(np.full(RSTP_H, 10.0)), RSTP_H,
            *seeded[4:])
    cases = [("seeded", seeded), ("flat", flat)] + list(
        zip(("loop first", "loop later"), scans))
    scan_err = 0.0
    for what, args in cases:
        got = rmp.scan(*args)
        want = rmp.scan_reference(*args)
        prof, cycles = rmp.profile(*args)
        torch.cuda.synchronize()
        err = float(torch.max(torch.abs(got - want)))
        same = bool(torch.equal(got, want))
        print(f"rstp_rampify check {what}: max|kernel-plain| {err:.3e}, "
              f"bit-exact {same}")
        # the same float32 operations in the same order, no FMA
        if not same or not torch.all(torch.isfinite(got)):
            raise AssertionError(f"rampify {what}: kernel and plain differ")
        if not torch.equal(got, prof):
            raise AssertionError(f"rampify {what}: the profiling "
                                 "instantiation's result differs")
        rampify_phase_line("rstp_rampify", what, rmp.PHASES, cycles, args,
                           mhz)
        scan_err = max(scan_err, err)

    lib = rmp._kernel()
    stream = torch.cuda.current_stream(dev).cuda_stream

    def kernel_args(args):
        v0, a0, lim_v, T, a_min, a_max, j_min, j_max, v_min, step = args
        return (v0, a0, a_min, a_max, j_min, j_max, v_min, step), lim_v, T

    what, args = cases[-1]
    scalars, lim_v, T = kernel_args(args)
    H = lim_v.shape[0]
    ptrs = rmp.pointers(scalars, lim_v)
    out = torch.empty((H, 2), dtype=torch.float32, device=dev)
    ms, wrapper_ms = launcher_times(
        "rstp_rampify", f"{what} at H={H}",
        lambda: lib.rstp_rampify_scan(ptrs, out.data_ptr(), H, T, stream),
        lambda: rmp.scan(*args), 200)
    plain_ms = cuda_ms(lambda: rmp.scan_reference(*args), 2)
    print(f"rstp_rampify at H={H}: kernel {ms:.4f} ms (bare launcher; "
          f"wrapper {wrapper_ms:.4f}), plain {plain_ms:.4f} ms")

    for csrc in parents_with(parent_csrc, "rstp_rampify"):
        # an earlier version takes one buffer: the 8 scalars, then the
        # limits, and has no phase count of its own
        from tpl_tpu_torch import _build

        old_style = not hasattr(_build.load("rstp_rampify", csrc),
                                "rstp_rampify_n_phases")
        packed, held = [], []
        for what, args in cases:
            scalars, lim_v, T = kernel_args(args)
            buf = torch.cat([torch.stack([s.reshape(()) for s in scalars]),
                             lim_v])
            ptrs = rmp.pointers(scalars, lim_v)
            held.append((buf, ptrs))
            case = [what, out,
                    lambda fn, o, ptrs=ptrs, T=T: fn(ptrs, o.data_ptr(), H, T,
                                                     stream)]
            if old_style:
                case.append(lambda fn, o, buf=buf, T=T: fn(
                    buf.data_ptr(), o.data_ptr(), H, T, stream))
            packed.append(case)
        parent = compare_with_parent(
            "rstp_rampify", lib.rstp_rampify_scan, csrc, packed, n=200)
        if old_style and hasattr(parent, "rstp_rampify_profile"):
            # a copy with phase stamps added: staging, the backward scan,
            # the forward scan, the write-out
            fn = parent.rstp_rampify_profile
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                           + [ctypes.c_void_p])
            names = ("stage", "backward", "forward", "store")
            for (what, args), (buf, _) in zip(cases, held):
                cyc = torch.zeros(len(names), dtype=torch.int64, device=dev)
                err = fn(buf.data_ptr(), out.data_ptr(), cyc.data_ptr(), H,
                         kernel_args(args)[2], stream)
                if err:
                    raise RuntimeError(f"launch failed: CUDA error {err}")
                rampify_phase_line("parent rstp_rampify", what, names,
                                   dict(zip(names, cyc.cpu().tolist())),
                                   args, mhz)
    return dict(scan_err=scan_err, scan_ms=(ms, wrapper_ms, plain_ms))


def rampify_phase_line(kernel, what, names, cycles, args, mhz):
    """One line of a profiled scan: microseconds per phase (thread 0's
    clock64() cycles over the SM clock) and cycles per step of each scan."""
    H = args[2].shape[0]
    us = ", ".join(f"{k} {cycles[k] / mhz:.2f}" for k in names)
    print(f"phases {kernel} {what} (H={H}, T={args[3]}, SM {mhz:.0f} MHz): "
          f"us: {us} (total {sum(cycles.values()) / mhz:.2f}); cycles per "
          f"step: backward {cycles['backward'] / (H - 1):.1f}, forward "
          f"{cycles['forward'] / H:.1f}")


def mpc_batch_inputs(B, dtype, dev, spread=None, seed=None):
    """The batch of the JAX package's bench (bench.py _mpc_batched_setup):
    the ``_mpc_setup`` course, weights and limits, zero warm start, starts
    ``x0 + 0.01 * b`` on every state (or ``x0 + 0.01 * (b % spread)``); with
    ``seed`` also a seeded offset of every start and seeded warm controls,
    multipliers and mu_steps (the scenarios stop after mixed iteration
    counts); in the batched update's layout on ``dev``."""
    import torch
    from tpl_tpu_torch.optim import batched, problems

    H = MPC_H
    ss = np.arange(128) * 0.5
    ref_y = 2.0 * np.sin(ss * 0.1)
    phi = np.arctan(np.gradient(ref_y, ss))
    params = {
        "pd": 10.0, "pv": 5.0, "pdelta": 0.0, "min_pdelta_dot": 0.1,
        "pdelta_dot": 0.0, "min_p_phi_dot": 0.0, "p_phi_dot": 0.0,
        "p_phi": 0.01, "p_phi_ref_dot_diff": 0.01, "pa": 2.0, "pj": 0.5,
        "l": 3.165, "v_ch": 32.0,
        "ref_x": ss, "ref_y": ref_y, "ref_phi": phi,
        "ref_k": np.gradient(phi, ss), "ref_v": np.full(128, 8.0),
        "ref_step": 0.5, "max_delta": 0.7, "max_acc": 3.0,
        "min_acc": -3.0, "a_offset": 0.0}
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64)).to(
        device=dev, dtype=dtype)
    b = np.arange(B) if spread is None else np.arange(B) % spread
    x0 = (np.array([0.0, 1.0, 0.0, 0.0, 5.0, 0.0, 0.0])[:, None]
          + 0.01 * b[None, :])
    rng = None if seed is None else np.random.default_rng(seed)
    if rng is not None:
        x0 = x0 + rng.normal(0.0, 0.3, (7, B)) * np.array(
            [1, 1, 0.2, 0.1, 3, 0, 0.5])[:, None]
    cfg = dict(u_min=t(np.tile([-3.0, -1.0], (H, 1))),
               u_max=t(np.tile([1.5, 1.0], (H, 1))),
               barrier_weight=t(np.full(4, 1e4)),
               lg_mult_limit=t(np.full(4, 1e30)), dt=t(0.05),
               min_rel_cost_change=t(1e-6), T=H,
               max_iterations=BATCH_ITERATIONS, max_lg_iterations=1)
    prob, _ = problems.trajectory_tracking_mpc(ref_capacity=128)
    x, u, lam, mu = batched.init_batch(prob, H, B, dtype, dev)
    if rng is not None:
        u = t(rng.normal(0.0, 0.3, (H, 2, B)))
        lam = t(rng.uniform(0.0, 1e-3, (H, 4, B)))
        mu = torch.as_tensor(rng.integers(0, 4, B), dtype=torch.int32,
                             device=dev)
    return prob, (x, u, lam, mu, t(x0), {k: t(v) for k, v in params.items()},
                  cfg)


def rows_out(itm):
    """Reals of one scenario's packed result at MPC_H."""
    from tpl_tpu_torch.optim import ilqr

    return ilqr.layout(itm.output_layout(MPC_H))[1]


def same_bits(a, b):
    """Whether two float tensors hold the same bits (NaN included)."""
    import torch

    view = torch.int64 if a.dtype == torch.float64 else torch.int32
    return a.shape == b.shape and bool(torch.equal(a.view(view),
                                                   b.view(view)))


def batched_launch(itm, lib, shared, rows, mu, out, work, stream):
    """A launch of the batched kernel through the bare launcher ``lib`` (of
    this tree or of a parent with the same interface) into ``out``; returns
    the CUDA error code."""
    from tpl_tpu_torch.optim import ilqr

    return lib.ilqr_tracking_mpc_batched(
        shared.data_ptr(), rows.data_ptr(), out.data_ptr(), mu.data_ptr(),
        work.data_ptr(), rows.shape[0], MPC_H, 128, MPC_H, BATCH_ITERATIONS,
        1, ilqr.HEUN, itm.DTYPES[rows.dtype], stream)


def parent_batched(itm, csrc, stream):
    """The batched entry of another version of ``ilqr_tracking_mpc.cu``
    (built from ``csrc``) as ``launch(shared, rows, mu, out, work)``, on the
    same split inputs.  A source without ``ilqr_tracking_mpc_batched_resident``
    is the earlier grid of one block per scenario, which takes the single
    solve's rows one after the other (``rows_of_batch``)."""
    import ctypes
    from tpl_tpu_torch import _build
    from tpl_tpu_torch.optim import ilqr

    lib = _build.load("ilqr_tracking_mpc", csrc)
    fn = lib.ilqr_tracking_mpc_batched
    fn.restype = ctypes.c_int
    if hasattr(lib, "ilqr_tracking_mpc_batched_resident"):
        fn.argtypes = itm._kernel().ilqr_tracking_mpc_batched.argtypes
        return lambda sh, rows, mu, out, work: batched_launch(
            itm, lib, sh, rows, mu, out, work, stream)
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    packed = {}

    def launch(sh, rows, mu, out, work):
        key = (sh.data_ptr(), rows.data_ptr())
        if key not in packed:
            packed.clear()
            packed[key] = itm.rows_of_batch(sh, rows, MPC_H, 128)
        return fn(packed[key].data_ptr(), out.data_ptr(), mu.data_ptr(),
                  rows.shape[0], MPC_H, 128, MPC_H, BATCH_ITERATIONS, 1,
                  ilqr.HEUN, itm.DTYPES[rows.dtype], stream)
    return launch


def batched_parent_check(itm, parent, csrc, dtype, dev, stream):
    """The tree's batched kernel against a parent's on every batch (the
    bench's, near the course, seeded warm starts) at every size of
    BATCH_SIZES, every scenario's bits; times in turns (parent, tree, tree,
    parent) through the bare launchers.  Any difference raises.  Returns
    {(batch, B): (parent ms, tree ms)}."""
    import torch

    tag = str(dtype).replace("torch.", "")
    lib = itm._kernel()
    times = {}
    for what, spread, seed in BATCH_CASES:
        for n in BATCH_SIZES:
            _, a = mpc_batch_inputs(n, dtype, dev, spread, seed)
            sh, rows = itm.pack_inputs_batched(a[0], a[1], a[2], a[4], a[5],
                                               a[6], dtype)
            mu = a[3].to(torch.int32).contiguous()
            outs = [torch.empty((n, rows_out(itm)), dtype=dtype, device=dev)
                    for _ in range(2)]
            work = torch.empty(1, dtype=torch.int32, device=dev)
            calls = (lambda: parent(sh, rows, mu, outs[0], work),
                     lambda: batched_launch(itm, lib, sh, rows, mu, outs[1],
                                            work, stream))

            def checked(i):
                err = calls[i]()
                if err:
                    raise RuntimeError(f"launch failed: CUDA error {err}")

            checked(0), checked(1)
            torch.cuda.synchronize()
            if not same_bits(outs[0], outs[1]):
                bad = (outs[0] != outs[1]).any(1).nonzero().flatten()
                raise AssertionError(
                    f"batched {tag} {what} B={n}: {len(bad)} scenarios differ "
                    f"from the parent kernel's (first {bad[:8].tolist()})")
            (pa, pd), (ta, tb) = in_turns(lambda: checked(0),
                                          lambda: checked(1), 5)
            times[what, n] = ((pa + pd) / 2, (ta + tb) / 2)
            print(f"ilqr_tracking_mpc_batched {tag} {what} B={n} vs the "
                  f"source in {csrc}: every scenario bit-equal; ms per batch "
                  f"parent {pa:.4f}, new {ta:.4f}, new {tb:.4f}, parent "
                  f"{pd:.4f}")
    return times


def batch_phase_line(tag, what, phases, hist, iterations, single_us, mhz):
    """One line of the batch's profiled scenario 0: microseconds per
    iteration by phase, beside the single solve's on the same problem
    (``single_us``, from phase_line), and the batch's line searches by the
    candidate they took."""
    us = {k: v / mhz / max(iterations, 1) for k, v in phases.items()}
    pairs = [k for k in phases if k.startswith("candidates_")]
    per_it = ", ".join(f"{k} {us[k]:.2f}" for k in (
        "derivatives", "expansion", "riccati", *pairs, "pick_copy"))
    single = ""
    if single_us:
        sit = {k: v / BATCH_ITERATIONS for k, v in single_us.items()}
        single = (f"; the single solve's: derivatives {sit['derivatives']:.2f}, "
                  f"riccati {sit['riccati']:.2f}, rollouts + step costs + "
                  f"sums {sit['rollouts'] + sit['step_costs'] + sit['cost_sums']:.2f}, "
                  f"pick_copy {sit['pick_copy']:.2f}")
    print(f"phases ilqr_tracking_mpc_batched {tag} {what} scenario 0 "
          f"({iterations} iterations, SM {mhz:.0f} MHz): us per iteration: "
          f"{per_it} (sum {sum(us[k] for k in ('derivatives', 'expansion', 'riccati', *pairs, 'pick_copy')):.2f}){single}; "
          f"line searches by the candidate taken (8: none): "
          f"{dict(zip(range(1, 9), hist))}")


def batched_phase(itm, dev, cycles, mhz, single_us=None, parent_csrc=None):
    """The batched tracking MPC at B=2048 on the card, float64 then
    float32: the main path (one update through ``make_batched_update_fn``),
    every scenario against the plain version, every 64th scenario and the
    last bit-equal to single launches, the profiled phases, the times at
    every size of BATCH_SIZES on the bench's batch and near the course, the
    bounds, and (with ``parent_csrc``) the parent's batched entry on every
    batch."""
    import torch
    from tpl_tpu_torch.optim import batched, ilqr

    H, n_ref, B = MPC_H, 128, BATCH
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = itm._kernel()
    parents = [(d, parent_batched(itm, d, stream))
               for d in parents_with(parent_csrc, "ilqr_tracking_mpc")]
    res = {}
    for dtype in (torch.float64, torch.float32):
        tag = str(dtype).replace("torch.", "")
        prob, args = mpc_batch_inputs(B, dtype, dev)
        upd = batched.make_batched_update_fn(prob, H, B, ilqr.HEUN, dtype)

        # the main path: one update, one launch
        itm.launches_batched = 0
        before_single = itm.launches
        got = upd(*args, iterations=True)
        torch.cuda.synchronize()
        launches = itm.launches_batched
        if launches != 1 or itm.launches != before_single:
            raise AssertionError(f"{tag}: {launches} batched launches for "
                                 "one update")
        want = upd.reference(*args, iterations=True, rolled=True)
        torch.cuda.synchronize()

        its = got[5].cpu().numpy()
        rolled = want[6].cpu().numpy()
        f64 = dtype == torch.float64
        atol, rtol, cost_rtol, min_share = (
            (BATCH_ATOL, BATCH_RTOL, MPC_COST_RTOL, BATCH_MIN_SHARE) if f64
            else (F32_X_ATOL, 0.0, F32_COST_RTOL, F32_MIN_SHARE))
        diffs = [(g - w).abs().amax((0, 1)) for g, w in zip(got[:3],
                                                            want[:3])]
        rel = ((got[4] - want[4]).abs() / want[4].abs().clamp(min=1e-30))
        same = (got[3] == want[3]) & (got[5] == want[5])
        ok = rel <= cost_rtol
        for g, w in zip(got[:3], want[:3]):
            ok &= torch.isclose(g, w, rtol=rtol, atol=atol).all(0).all(0)
        if not f64:
            ok &= same
        share = float(ok.float().mean())
        err_ok = max(float(d[ok].max()) for d in diffs)
        err_all = max(float(d.max()) for d in diffs)
        print(f"batched check {tag} B={B}: {int(ok.sum())} of {B} scenarios "
              f"within the tolerance (max|kernel - plain| over x, u, lam "
              f"{err_ok:.3e} on them, {err_all:.3e} on all; cost rel "
              f"{float(rel[ok].max()):.3e} / {float(rel.max()):.3e}); mu_step "
              f"and iterations equal on {int(same.sum())}; iterations min "
              f"{its.min()} median {np.median(its):.0f} max {its.max()}, "
              f"histogram {np.bincount(its, minlength=9).tolist()}; "
              f"candidates the sequential search rolls (plain) "
              f"{int(rolled.sum())}, {rolled.sum() / its.sum():.2f} a search")
        for b in torch.nonzero(~ok).flatten().tolist()[:24]:
            d0 = float(args[4][3, b])
            print(f"  scenario {b}: max|dx| {float(diffs[0][b]):.3e}, max|du| "
                  f"{float(diffs[1][b]):.3e}, cost rel {float(rel[b]):.3e}, "
                  f"iterations {int(got[5][b])}/{int(want[5][b])}, mu_step "
                  f"{int(got[3][b])}/{int(want[3][b])}, start delta "
                  f"{d0:.2f} rad (cos {np.cos(d0):+.4f}), max|x| "
                  f"{float(got[0][..., b].abs().max()):.3e}")
        if not all(bool(torch.isfinite(g).all()) for g in got[:3]):
            raise AssertionError(f"{tag}: non-finite batched solve")
        if share < min_share:
            raise AssertionError(f"{tag} batch: only {share:.4f} of the "
                                 "scenarios within the tolerance")
        if f64 and not bool(same.all()):
            raise AssertionError("float64 batch: mu_step / iterations "
                                 "differ from the plain version's")

        # the packed batch through the bare launcher; every 64th scenario
        # and the last against single launches on their rows (float64: the
        # same bits)
        x, u, lam, mu, x0, params, cfg = args
        shared, rows = itm.pack_inputs_batched(x, u, lam, x0, params, cfg,
                                               dtype)
        out = itm.launch_batched(shared, rows, mu, H, n_ref, H,
                                 BATCH_ITERATIONS)
        torch.cuda.synchronize()
        if f64:
            single = itm.rows_of_batch(shared, rows, H, n_ref)
            picks = sorted(set(range(0, B, 64)) | {B - 1})
            for b in picks:
                one = itm.update(single[b].contiguous(), H, n_ref, H,
                                 BATCH_ITERATIONS, 1, int(mu[b]), ilqr.HEUN)
                if not same_bits(out[b], one):
                    raise AssertionError(f"scenario {b} of the batch and a "
                                         "single launch differ")
            print(f"batched check float64: the {len(picks)} scenarios 0, 64, "
                  f"..., {B - 1} are bit-equal to single launches")

        # the profiling instantiation: the same bits, scenario 0's phases
        # beside the single solve's on the same problem, the line searches
        prof_out, prof_phases, hist = itm.profile_batched(
            shared, rows, mu, H, n_ref, H, BATCH_ITERATIONS)
        if not same_bits(prof_out, out):
            raise AssertionError(f"{tag}: the batch's profiling "
                                 "instantiation's result differs")
        kernel_rolled = int(sum(k * h for k, h in zip(range(1, 9), hist)))
        print(f"batched {tag}: the kernel's line searches took candidates "
              f"worth {kernel_rolled} sequential rollouts (plain: "
              f"{int(rolled.sum())})")
        batch_phase_line(tag, "bench", prof_phases, hist, int(its[0]),
                         single_us if f64 else None, mhz)
        # the team geometry on the bench's scenario 0 alone
        one = tuple(t[..., :1].contiguous() for t in (x, u, lam, x0))
        sh1, rows1 = itm.pack_inputs_batched(*one[:3], one[3], params, cfg,
                                             dtype)
        out1 = itm.launch_batched(sh1, rows1, mu[:1].contiguous(), H, n_ref,
                                  H, BATCH_ITERATIONS)
        p_out1, p_ph1, p_hist1 = itm.profile_batched(
            sh1, rows1, mu[:1].contiguous(), H, n_ref, H, BATCH_ITERATIONS)
        if not (same_bits(p_out1, out1) and same_bits(out1, out[:1])):
            raise AssertionError(f"{tag}: the team geometry's scenario 0 "
                                 "differs from the batch's")
        batch_phase_line(tag, "bench B=1, team geometry (candidates_0_* "
                         "holds all 8)", p_ph1, p_hist1,
                         int(itm.unpack_outputs_batched(out1, H)[5][0]),
                         single_us if f64 else None, mhz)

        per_sm, slots = itm.resident_scenarios(H, n_ref, dtype)
        shared_b, slot_b = itm.batched_bytes(H, n_ref, dtype)
        print(f"batched {tag}: {shared_b} B of shared memory a block for "
              f"the shared part, {slot_b} B a scenario, {slots} scenarios "
              f"a block, {per_sm} scenarios per SM, {sms} SMs: "
              f"{sms * per_sm} at a time")
        group = itm.SIDE_BY_SIDE[dtype]
        team = itm.team_scenarios(H, n_ref, dtype)
        print(f"batched {tag}: a warp rolls {group} candidates a round; the "
              f"team geometry (a block of {8 // group} warps a scenario, "
              f"all 8 candidates in one round) holds {team} scenarios per "
              f"SM and takes the batches of B <= {sms * team}: "
              f"{[n for n in BATCH_SIZES if n <= sms * team]} of "
              f"{list(BATCH_SIZES)}")

        if not f64:
            # seeded warm starts: where float32 rounding decides mu_step
            # and the stopping iteration, the kernel against the plain
            # float32 update beside the plain float32 against float64
            seeded = BATCH_CASES[2]
            a32 = mpc_batch_inputs(B, dtype, dev, *seeded[1:])[1]
            a64 = mpc_batch_inputs(B, torch.float64, dev, *seeded[1:])[1]
            upd_s = batched.make_batched_update_fn(prob, H, B, ilqr.HEUN,
                                                   dtype)
            k32 = upd_s(*a32, iterations=True)
            p32 = upd_s.reference(*a32, iterations=True)
            p64 = batched.make_batched_update_fn(
                prob, H, B, ilqr.HEUN, torch.float64).reference(
                    *a64, iterations=True)
            torch.cuda.synchronize()

            def split(g, w):
                return float(((g[3] != w[3]) | (g[5] != w[5])).float().mean())

            f32_split = dict(kernel_plain=split(k32, p32),
                                plain_f64=split(p32, p64),
                                kernel_f64=split(k32, p64))
            print(f"batched float32 seeded warm starts B={B}: mu_step or "
                  f"the stopping iteration differ on a share "
                  f"{f32_split['kernel_plain']:.4f} kernel vs plain "
                  f"float32, {f32_split['plain_f64']:.4f} plain float32 "
                  f"vs plain float64, {f32_split['kernel_f64']:.4f} "
                  f"kernel vs plain float64")

        # the times: the bench's batch and the batch near the course at
        # every size, through the bare launcher and the wrapper in turns
        f32 = itm.DTYPES[dtype]
        times = {}
        for what, spread, _ in BATCH_CASES[:2]:
            for n in BATCH_SIZES:
                _, a = mpc_batch_inputs(n, dtype, dev, spread)
                upd_n = batched.make_batched_update_fn(prob, H, n, ilqr.HEUN,
                                                       dtype)
                sh_n, rows_n = itm.pack_inputs_batched(
                    a[0], a[1], a[2], a[4], a[5], a[6], dtype)
                out_n = torch.empty((n, out.shape[1]), dtype=dtype,
                                    device=dev)
                work = torch.empty(1, dtype=torch.int32, device=dev)
                times[what, n] = launcher_times(
                    "ilqr_tracking_mpc_batched", f"{tag} {what} B={n}",
                    lambda: batched_launch(itm, lib, sh_n, rows_n, a[3],
                                           out_n, work, stream),
                    lambda: upd_n(*a), 10)

        # every scenario near the course (starts x0 + 0.01 * (b % 8)): its
        # iterations, the candidates the plain version's search rolls, the
        # bound and the floor of this design
        _, a = mpc_batch_inputs(B, dtype, dev, spread=8)
        upd_t = batched.make_batched_update_fn(prob, H, B, ilqr.HEUN, dtype)
        its_t = upd_t(*a, iterations=True)[5].cpu().numpy()
        rolled_t = upd_t.reference(*a, iterations=True,
                                   rolled=True)[6].cpu().numpy()
        rounds_t = upd_t.reference(*a, iterations=True, rolled=True,
                                   group=group)[6].cpu().numpy()

        def bounds(its_b, rolled_b, rounds_b):
            """The roofline, the bound of any design, the longest chain
            (one rollout an iteration) and the floor of this design (each
            scenario's chain with its searches' rounds of ``group``)."""
            roof = itm.roofline_ms_batched(H, n_ref, H, its_b, rolled_b,
                                           dtype)
            bound = itm.bound_ms_batched(H, n_ref, H, its_b, rolled_b, cycles,
                                         mhz, dtype)
            chain = itm.chain_ms(H, H, int(max(its_b)), cycles, mhz,
                                 dtype=dtype)
            chains = [itm.chain_ms(H, H, int(i), cycles, mhz, rolled=int(r),
                                   dtype=dtype)
                      for i, r in zip(its_b, rounds_b)]
            return roof, bound, chain, itm.floor_ms_batched(chains, sms,
                                                            per_sm)

        tame = dict(zip(("roof", "bound", "chain", "floor"),
                        bounds(its_t, rolled_t, rounds_t)))
        tame.update(ms=times["near course", B][0],
                    wrapper_ms=times["near course", B][1],
                    mean_iterations=float(its_t.mean()),
                    rolled=int(rolled_t.sum()))
        rounds = upd.reference(*args, iterations=True, rolled=True,
                               group=group)[6].cpu().numpy()
        roof, bound, chain, floor = bounds(its, rolled, rounds)
        plain_ms = cuda_ms(lambda: upd.reference(*args), 1, warm=0)
        ms, wrapper_ms = times["bench", B]
        for what, t, its_b, rolled_b, (r, bd, ch, fl) in (
                ("bench", (ms, wrapper_ms), its, rolled,
                 (roof, bound, chain, floor)),
                ("near course", (tame["ms"], tame["wrapper_ms"]), its_t,
                 rolled_t, (tame["roof"], tame["bound"], tame["chain"],
                            tame["floor"]))):
            print(f"batched {tag} {what} B={B} H={H} {BATCH_ITERATIONS} "
                  f"iterations HEUN (iterations histogram "
                  f"{np.bincount(its_b, minlength=9).tolist()}, "
                  f"{int(rolled_b.sum())} candidates rolled by the "
                  f"sequential search): kernel {t[0]:.3f} ms per batch "
                  f"({B / t[0] * 1e3:.0f} solves/s), wrapper {t[1]:.3f} ms "
                  f"({B / t[1] * 1e3:.0f} solves/s); roofline {r[0]:.4f} ms "
                  f"by {r[1]}, longest scenario's chain {ch:.4f} ms "
                  f"({tag} latencies), bound {bd[0]:.4f} ms by {bd[1]}, "
                  f"floor of the design {fl:.4f} ms (rounds of {group})")
        print(f"batched {tag}: plain {plain_ms:.1f} ms per batch (the bench's)")
        parent_times = {}
        for csrc, parent in parents:
            parent_times[csrc] = batched_parent_check(itm, parent, csrc,
                                                      dtype, dev, stream)
        res[tag] = dict(
            launches=launches, err=err_ok, err_all=err_all, share=share,
            ms=ms, wrapper_ms=wrapper_ms, tame=tame, plain_ms=plain_ms,
            roof=roof, bound=bound, chain=chain, floor=floor,
            resident=per_sm, slots=slots, bytes=(shared_b, slot_b),
            team=team, group=group, rolled=int(rolled.sum()),
            split=None if f64 else f32_split,
            phases={k: v / mhz for k, v in prof_phases.items()}, hist=hist,
            by_batch={f"{w} {n}": t[0] for (w, n), t in times.items()},
            wrapper_by_batch={f"{w} {n}": t[1]
                              for (w, n), t in times.items()},
            parent_by_batch={f"{w} {n}": t for c, pt in parent_times.items()
                             for (w, n), t in pt.items()})
    return res


def record_native_calls(native, keep=3):
    """Wraps the four C routes so that the first ``keep`` argument sets of
    each are kept (copied); returns (records, restore)."""
    rec = {k: [] for k in native.ROUTES}
    orig = {k: getattr(native, k) for k in native.ROUTES}

    def wrap(name):
        def run(*args, **kw):
            if len(rec[name]) < keep and not kw:
                rec[name].append(tuple(np.array(a) if isinstance(
                    a, np.ndarray) else a for a in args))
            return orig[name](*args, **kw)
        return run

    for k in native.ROUTES:
        setattr(native, k, wrap(k))

    def restore():
        for k, fn in orig.items():
            setattr(native, k, fn)
    return rec, restore


def native_phase(native, recorded, loop_calls):
    """Each C route against its numpy path, on the follow loop's own calls
    (``recorded``) and on seeded inputs; ``loop_calls`` are the loop's C
    calls per route."""
    from tpl_tpu_torch.ops import geometry, profile
    from tpl_tpu_torch.planning.path_vel_decomp import path_optim

    if native.get_lib() is None or not native.enabled():
        raise AssertionError("the host C library is not loaded")
    rng = np.random.default_rng(0)
    pts = np.cumsum(rng.normal(0, 1.0, (60, 2)), axis=0)
    lim = np.maximum(1.0, 10.0 + np.cumsum(rng.normal(0, 1.0, RSTP_H)))
    path = np.zeros((RSTP_H, 6))
    path[:, 5] = rng.uniform(0.0, 12.0, RSTP_H)
    lower, upper = np.full(RSTP_H, -3.0), np.full(RSTP_H, 3.0)
    lower[80:95] = 0.5
    seeded = {
        "project": [(pts, rng.normal(0, 5.0, (17, 2)), False),
                    (pts[:23], rng.normal(0, 5.0, (9, 2)), True)],
        "resample": [(pts, 0.5, 100, 0, False), (pts[:20], 0.7, 90, 3, True)],
        "rampify_profile": [(8.0, 0.3, lim, -2.5, 2.5, -1.5, 1.5, 1.0, 0.5),
                            (None, None, lim, -2.5, 2.5, -1.5, 1.5, 1.0,
                             0.5)],
        "rampify_corridor": [(0.5, RSTP_H, 20.0, 0.3, path, 2.0, lower,
                              upper)]}
    port = {"project": geometry._project_core, "resample": geometry.resample,
            "rampify_profile": profile.rampify_profile,
            "rampify_corridor": path_optim.rampify_corridor}
    atol = {"project": 1e-12, "resample": 1e-12, "rampify_profile": 0.0,
            "rampify_corridor": 0.0}

    def flat(res):
        if isinstance(res, dict):
            return np.concatenate([np.asarray(res[k], np.float64).reshape(-1)
                                   for k in sorted(res)])
        return np.asarray(res, np.float64).reshape(-1)

    for route in native.ROUTES:
        cases = [("loop", a) for a in recorded[route]] + [
            ("seeded", a) for a in seeded[route]]
        worst = 0.0
        for what, a in cases:
            before = native.calls[route]
            got = flat(port[route](*a))
            if native.calls[route] != before + 1:
                raise AssertionError(f"{route}: the hook did not take the C "
                                     "route")
            was = native.enable(False)
            try:
                want = flat(port[route](*a))
            finally:
                native.enable(was)
            if native.calls[route] != before + 1:
                raise AssertionError(f"{route}: the numpy path reached the C "
                                     "route")
            if got.shape != want.shape:
                raise AssertionError(f"{route} {what}: shapes differ")
            both = np.isfinite(got) & np.isfinite(want)
            if not np.array_equal(np.isfinite(got), np.isfinite(want)):
                raise AssertionError(f"{route} {what}: non-finite entries "
                                     "differ")
            err = float(np.max(np.abs(got[both] - want[both]), initial=0.0))
            worst = max(worst, err)
            if err > atol[route]:
                raise AssertionError(f"{route} {what}: C and numpy differ by "
                                     f"{err:.3e}")
        print(f"host route {route}: C (hostops.cpp), {loop_calls[route]} "
              f"calls in the follow loop; against the numpy path on "
              f"{len(recorded[route])} of the loop's calls and "
              f"{len(seeded[route])} seeded: max|C - numpy| {worst:.3e} "
              f"(tolerance {atol[route]:.0e})")


def host_profile_phase(native, ticks):
    """cProfile of ``ticks`` ticks of the vendored RSTP loop on
    demo/country_follow, with the host C routes off and on."""
    import cProfile
    import pstats
    import torch
    from tpl_tpu_torch.simulation import SimStandalone

    routed = {"_project_core": "project", "resample": "resample",
              "rampify_profile": "rampify_profile",
              "rampify_corridor": "rampify_corridor"}
    card = smi("name,power.limit")
    for on in (False, True):
        native.enable(on)
        sim = SimStandalone(app_id=f"smoke_prof_{int(on)}",
                            scenario_path="demo/country_follow")
        store = sim.planning_app.sh_planners
        controllers = sim.control_app.sh_controllers
        with sim.core.sh_state.lock():
            ss = sim.core.sh_state.sim
            ss.settings.running = True
            ss.settings.use_real_time = False
        # past the cold solves and the collision screen's latch (the hard
        # brake over t = 0.04-1.03 s, while the MPC does not solve)
        for _ in range(PROFILE_SKIP_TICKS):
            sim.update()
        torch.cuda.synchronize()
        for k in native.ROUTES:
            native.calls[k] = 0
        tick_ms, plan_ms, control_ms = [], [], []
        prof = cProfile.Profile()
        for _ in range(ticks):
            t0 = time.perf_counter()
            prof.enable()
            sim.update()
            prof.disable()
            torch.cuda.synchronize()
            tick_ms.append((time.perf_counter() - t0) * 1e3)
            with store.lock():
                plan_ms.append(store.runtime * 1e3)
            with controllers.lock():
                control_ms.append(controllers.runtime * 1e3)
        st = pstats.Stats(prof)
        total = st.total_tt
        rows = sorted(st.stats.items(), key=lambda kv: -kv[1][3])
        what = "C routes on" if on else "C routes off (numpy paths)"
        print(f"host profile, {what}, {ticks} ticks of demo/country_follow "
              f"(RSTP fused + MPC) on {card}: {total / ticks * 1e3:.2f} ms of "
              f"profiled host time per tick; tick wall median "
              f"{np.median(tick_ms):.2f} ms, planning {np.median(plan_ms):.2f}"
              f", control {np.median(control_ms):.2f}; C calls per tick "
              + json.dumps({k: round(v / ticks, 2)
                            for k, v in native.calls.items()}))
        print("  top 10 by cumulative time (ms per tick, calls per tick, "
              "function):")
        shown = 0
        for (fname, line, func), (cc, nc, tt, ct, _) in rows:
            print(f"  {ct / ticks * 1e3:9.3f} ms {nc / ticks:8.1f} calls  "
                  f"{os.path.basename(fname)}:{line}({func}), own "
                  f"{tt / ticks * 1e3:.3f} ms")
            shown += 1
            if shown == 10:
                break
        for (fname, line, func), (cc, nc, tt, ct, _) in rows:
            if func in routed and "tpl_tpu_torch" in fname and (
                    "native" not in fname):
                print(f"  routed {func} ({os.path.basename(fname)}): "
                      f"{ct / ticks * 1e3:.3f} ms per tick cumulative, "
                      f"{nc / ticks:.1f} calls per tick")
        for name in ("prepare", "update_environment", "update"):
            for (fname, line, func), (cc, nc, tt, ct, _) in rows:
                if func == name and any(m in fname for m in (
                        "path_optim", "velocity_optim", "environment_app",
                        "planning_app", "control_app")):
                    print(f"  {os.path.basename(fname)}:{func}: "
                          f"{ct / ticks * 1e3:.3f} ms per tick cumulative")
    native.enable(True)


def fas_counts(tlk, plk, rmp, reset=False):
    """The chain's kernel launch counters by entry (set to 0 with
    ``reset``)."""
    if reset:
        tlk.launches = tlk.backward_launches = tlk.forward_launches = 0
        plk.launches = 0
        rmp.launches = rmp.start_launches = 0
    return {"lon_dp_backward": tlk.backward_launches,
            "lon_dp_forward": tlk.forward_launches,
            "poly_lat_sweep_select": plk.launches,
            "rstp_rampify_start": rmp.start_launches}


def record_fas_calls(tlk, plk, rmp):
    """Wraps the chain's four kernel entries so that copies of the
    arguments of their first calls (the first replan's inputs; every
    backward slice of its solve, the final one first) are kept.  Returns
    (recorded by row name, restore)."""
    import torch

    mods = {"backward_slice": tlk, "forward": tlk, "sweep_select": plk,
            "scan_start": rmp}
    rec = {row: [] for row, _, _ in FAS_ENTRIES}
    saved = []
    for row, name, keep in FAS_ENTRIES:
        mod = mods[name]
        fn = getattr(mod, name)
        saved.append((mod, name, fn))

        def wrapped(*args, _fn=fn, _row=row, _keep=keep, **kw):
            if len(rec[_row]) < _keep:
                rec[_row].append(tuple(a.clone() if torch.is_tensor(a) else a
                                       for a in args))
            return _fn(*args, **kw)

        setattr(mod, name, wrapped)

    def restore():
        for mod, name, fn in saved:
            setattr(mod, name, fn)

    return rec, restore


def fas_loop_phase(tlk, plk, rmp, planner_name, ticks, record=False):
    """SimStandalone on demo/country_follow with ``planner_name`` (the
    FAS-2025 chain's planners) active and the scenario's own sets, the
    chain on the card; the launch counters set to 0 just before the loop
    and read just after.  Checks zero rule violations, no emergency plan,
    finite controls and each of the chain's kernels launched exactly as
    often per replan as a replan launches it; prints the end state beside
    the JAX package's CPU loop's, the per-replan wall (the planner's own
    ``runtime_dp``) and the launches of one replan (torch.profiler)."""
    import torch
    from tpl_tpu_torch.simulation import SimStandalone

    sim = SimStandalone(app_id=f"smoke_{planner_name}",
                        scenario_path="demo/country_follow")
    store = sim.planning_app.sh_planners
    with store.lock():
        store.active_planner = planner_name
        prm = getattr(store, planner_name).params
        if planner_name == FAS:
            lat, lon = prm.planner.cpp_lat, prm.planner.cpp_lon
        else:
            lat, lon = prm.planner.lat_sampling, prm.planner.dyn_prog
        env = prm.env.cpp
        grid = ((lat.l_dst_steps, lat.s_dst_steps, lat.s_steps),
                (lon.t_steps, lon.s_steps, lon.v_steps, lon.a_steps,
                 lon.path_steps), (env.t_steps, env.s_steps, env.l_steps))
    if grid != FAS_GRID[planner_name]:
        raise AssertionError(f"{planner_name} grid {grid} != "
                             f"{FAS_GRID[planner_name]}")
    planner = sim.planning_app.planners[planner_name]
    controllers = sim.control_app.sh_controllers
    with sim.core.sh_state.lock():
        ss = sim.core.sh_state.sim
        ss.settings.running = True
        ss.settings.use_real_time = False
        ss.rule_checker.enable = True
    chain_args = []
    replan = planner.chain.replan

    def recording_replan(*args):
        chain_args[:] = [args]
        return replan(*args)

    planner.chain.replan = recording_replan
    rec, restore = record_fas_calls(tlk, plk, rmp) if record else (
        None, lambda: None)
    tick_ms, replan_ms = [], []
    last = planner.policy.last_replan_time
    fas_counts(tlk, plk, rmp, reset=True)
    try:
        for k in range(ticks):
            t0 = time.perf_counter()
            sim.update()
            torch.cuda.synchronize()
            tick_ms.append((time.perf_counter() - t0) * 1e3)
            if planner.policy.last_replan_time != last:
                last = planner.policy.last_replan_time
                replan_ms.append(planner.runtime_dp)
            with store.lock():
                emergency = store.trajectory.emergency
            with controllers.lock():
                controls = np.array(controllers.controls)
            if emergency:
                raise AssertionError(f"{planner_name} tick {k}: emergency "
                                     "trajectory")
            if not np.all(np.isfinite(controls)):
                raise AssertionError(f"{planner_name} tick {k}: non-finite "
                                     "controls")
        counts = fas_counts(tlk, plk, rmp)
    finally:
        restore()
    n = len(replan_ms)
    T = grid[1][0]
    per_replan = {"lon_dp_backward": T - 1, "lon_dp_forward": 1,
                  "poly_lat_sweep_select": 1, "rstp_rampify_start": 1}
    for row, per in per_replan.items():
        if n == 0 or counts[row] != per * n:
            raise AssertionError(f"{planner_name}: {counts[row]} {row} "
                                 f"launches for {n} replans")
    with sim.core.sh_state.lock():
        s = sim.core.sh_state.sim
        violations = list(s.rule_checker.violations)
        t_end, x_end, v_end = s.t, s.ego.x, s.ego.v
    if violations:
        raise AssertionError(f"{planner_name}: rule violations "
                             f"{violations[:3]}")
    if not v_end > 4.0:
        raise AssertionError(f"{planner_name}: ego speed {v_end} at the end")
    jt, jx, jv = FAS_JAX_END[planner_name]
    total = count_launches(lambda: planner.chain.replan(*chain_args[0]))
    kernels = sum(per_replan.values())
    print(f"{planner_name}: {ticks} ticks to t={t_end:.2f} s, ego x "
          f"{x_end:.2f} v {v_end:.2f} m/s (the JAX package's CPU loop: "
          f"t={jt:.2f} s, x {jx:.2f} v {jv:.2f}), 0 violations, no "
          f"emergency, {n} replans; launches per replan: {kernels} kernels "
          f"of the chain ({', '.join(f'{r} {p}' for r, p in per_replan.items())})"
          f" of {total} in all (torch.profiler, one replan of the last "
          f"inputs)")
    print(f"{planner_name}: per-replan wall ms (runtime_dp): median "
          f"{np.median(replan_ms):.3f}, max {np.max(replan_ms):.3f} (first "
          f"{replan_ms[0]:.3f}); per-tick total wall ms: median "
          f"{np.median(tick_ms):.3f}, max {np.max(tick_ms):.3f}")
    return dict(counts=counts, replans=n, replan_ms=replan_ms, rec=rec,
                total=total, end=(t_end, x_end, v_end))


def lon_check(got, want, what):
    """A lon backward slice of the kernel against the plain version's:
    the jerks as indices equal on all but MAX_TIE_SHARE of the nodes, cost
    and constraint within tolerance on the others.  Returns (max abs err
    where the jerks agree, share of differing jerks)."""
    import torch

    got, want = got.cpu(), want.cpu()
    flips = got[..., 2] != want[..., 2]
    share = float(flips.float().mean())
    if share > MAX_TIE_SHARE:
        raise AssertionError(f"{what}: jerks differ on {share:.2e} of nodes")
    keep = ~flips
    np.testing.assert_allclose(got[..., 0][keep], want[..., 0][keep],
                               rtol=COST_RTOL, atol=COST_ATOL,
                               err_msg=what + " cost")
    np.testing.assert_allclose(got[..., 1][keep], want[..., 1][keep], rtol=0,
                               atol=CONSTR_ATOL, err_msg=what + " constr")
    return float(torch.max(torch.abs(got - want)[keep])), share


def lon_bits_on_cpu(tlk, cases, what):
    """Every backward slice of ``cases`` (the wrapper's arguments) through
    the kernel, bit for bit against the plain version on the CPU."""
    import torch

    for a in cases:
        cpu = tuple(x.cpu() if torch.is_tensor(x) else x for x in a)
        if not torch.equal(tlk.backward_slice_reference(*cpu),
                           tlk.backward_slice(*a).cpu()):
            raise AssertionError(f"lon_dp_backward {what} slice {a[4]}: "
                                 "kernel and plain version on the CPU differ")


def lon_plan_line(tlk, pp, S, V, A, P, what):
    """Prints the backward kernel's plan for the parameters ``pp`` (a CUDA
    tensor) at S x V x A over a path of P rows: the tile, the largest box's
    bytes (``tlk.box_bytes``), the threads and blocks, shared memory,
    registers; returns it as a dict."""
    import torch

    tile, cap = tlk._plan(pp, S, V, A, P)
    host = pp.cpu().numpy()
    sms = torch.cuda.get_device_properties(pp.device).multi_processor_count
    n_tiles = -(-S // tile)
    plan = dict(tile=tile, box_cap=cap,
                box_bytes=tlk.box_bytes(host, S, V, A, tile),
                threads=tlk.backward_threads(A, tile),
                blocks=V * n_tiles,
                smem_bytes=tlk.backward_smem_bytes(A, tile, P, cap),
                registers=ptxas_usage("lon_dp")[0])
    print(f"lon_dp_backward plan, {what} ({S} x {V} x {A}): {tile} s rows a "
          f"block, the largest box {plan['box_bytes']} B "
          f"(tlk.box_bytes), {plan['smem_bytes']} B of shared memory, "
          f"{plan['threads']} threads, {plan['blocks']} blocks on {sms} "
          f"SMs, {plan['registers']} registers a thread (ptxas)")
    return plan


def lon_parent_check(tlk, cases, dev, parent_csrc, timed):
    """With ``parent_csrc``: the backward slice of another version of
    ``lon_dp.cu`` (the earlier launcher, one thread a node, or this one's)
    against the tree's on every case ((what, the wrapper's arguments)),
    every bit (a difference raises); the times in turns through the bare
    launchers and, since a slice takes about as long as the host takes to
    launch it, from CUDA graphs (``graph_ms``, parent, tree, tree, parent)
    printed for each case.  Returns {"events": (parent, new, new, parent)
    ms, "graph": the same from graphs} of the case ``timed`` for the first
    parent, or None."""
    import ctypes
    import torch
    from tpl_tpu_torch import _build

    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = tlk._kernel()
    times, graphs = {}, {}
    for k, csrc in enumerate(parents_with(parent_csrc, "lon_dp")):
        with open(os.path.join(csrc, "lon_dp.cu")) as f:
            old = "int tile, int box_cap" not in f.read()

        def launcher(fn, out, a, parent):
            nxt, pp, path, dist, t_idx, last = a
            S, V, A = nxt.shape[:3]
            head = (nxt.data_ptr(), pp.data_ptr(), path.data_ptr(),
                    dist.data_ptr(), out.data_ptr(), S, V, A, path.shape[0],
                    int(t_idx), int(bool(last)))
            tail = () if parent and old else tlk._plan(pp, S, V, A,
                                                       path.shape[0])
            return lambda s: fn(*head, *tail, s)

        compare_with_parent(
            "lon_dp", lib.lon_dp_backward, csrc,
            [(what, a[0],
              lambda fn, out, a=a: launcher(fn, out, a, False)(stream),
              lambda fn, out, a=a: launcher(fn, out, a, True)(stream))
             for what, a in cases],
            n=100, times=times if k == 0 else None,
            argtypes=([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                      + [ctypes.c_void_p]) if old else None)
        parent = getattr(_build.load("lon_dp", csrc), "lon_dp_backward")
        for what, a in cases:
            outs = [torch.empty_like(a[0]) for _ in range(2)]
            fns = [launcher(parent, outs[0], a, True),
                   launcher(lib.lon_dp_backward, outs[1], a, False)]

            def checked(i):
                def run(s):
                    if fns[i](s):
                        raise RuntimeError("lon_dp_backward launch failed")
                return run

            t = (graph_ms(checked(0)), graph_ms(checked(1)),
                 graph_ms(checked(1)), graph_ms(checked(0)))
            if k == 0:
                graphs[what] = t
            print(f"lon_dp {what} vs the source in {csrc}, from CUDA graphs: "
                  f"ms per launch parent {t[0]:.4f}, new {t[1]:.4f}, new "
                  f"{t[2]:.4f}, parent {t[3]:.4f}")
    if timed not in times:
        return None
    return {"events": times[timed], "graph": graphs[timed]}


def lon_seeded_phase(tlk, dev, parent_csrc=None):
    """``--kernels-only``: every backward slice of a seeded solve at the
    demo width (lon T=10, S=201, V=37, A=20, P=200) and of the edge grids
    of ``scenes.LON_EDGE``, from the plain next slice, bit for bit against
    the plain version on the CPU and (with ``parent_csrc``) against
    another version's kernel, timed in turns."""
    import torch
    from tpl_tpu_torch.scenes import LON_DEMO, LON_EDGE, lon_nodes, lon_scene

    on = lambda *a: tuple(torch.as_tensor(np.asarray(x)).to(dev) for x in a)
    grids = [("demo", tuple(LON_DEMO[k] for k in "TSVAP"), 5, True)]
    grids += [(f"edge {g}", g, 3, False) for g in LON_EDGE]
    cases = []
    for what, (T, S, V, A, P), seed, demo in grids:
        pp, path, dist, _ = lon_scene(S, V, A, P, T, seed, demo=demo)
        args = on(pp, path, dist)
        nodes = lon_nodes(pp, path, dist, T, S, V, A, dev=dev)
        slices = [(nodes[min(i + 1, T - 1)],) + args + (i, i == T - 1)
                  for i in range(T - 1, 0, -1)]
        lon_bits_on_cpu(tlk, slices, what)
        lon_plan_line(tlk, args[0], S, V, A, P, what)
        print(f"lon_dp_backward {what}: {len(slices)} slices bit-equal to "
              "the plain version on the CPU")
        cases += [(f"{what} slice {a[4]}", a) for a in slices]
    lon_parent_check(tlk, cases, dev, parent_csrc, cases[1][0])


def forward_launch(fn, a, out, mode=0, traj=None):
    """``launch(stream)`` of the bare launcher ``fn`` of ``lon_dp_forward``
    on the forward pass's arguments ``a`` (nodes, pp, path, dist, x0): the
    forward pass into ``out``, or with ``mode`` 1 the reeval pass of
    ``traj``."""
    nodes, pp, path, dist, x0 = a
    T, S, V, A = nodes.shape[:4]
    states = x0 if mode == 0 else traj
    rows = T if mode == 0 else traj.shape[0]
    return lambda s: fn(nodes.data_ptr(), pp.data_ptr(), path.data_ptr(),
                        dist.data_ptr(), states.data_ptr(), out.data_ptr(),
                        T, S, V, A, path.shape[0], rows, mode, s)


def timed_in_turns(source, what, csrc, old, new, n=100):
    """Prints and returns the times of ``old(stream)`` (the other
    version's launch) and ``new(stream)`` in turns, by CUDA events and from
    CUDA graphs: {"events": (parent, new, new, parent) ms, "graph": the
    same}."""
    import torch

    stream = torch.cuda.current_stream().cuda_stream
    old_r, new_r = raising(old), raising(new)
    (a, d), (b, c) = in_turns(lambda: old_r(stream), lambda: new_r(stream),
                              n)
    graph = in_turns_graph(old_r, new_r)
    print(f"{source} {what} vs the source in {csrc}: ms per launch parent "
          f"{a:.4f}, new {b:.4f}, new {c:.4f}, parent {d:.4f}; from CUDA "
          f"graphs parent {graph[0]:.4f}, new {graph[1]:.4f}, new "
          f"{graph[2]:.4f}, parent {graph[3]:.4f}")
    return {"events": (a, b, c, d), "graph": graph}


def forward_parent_check(tlk, cases, parent_csrc, timed):
    """With ``parent_csrc``: ``lon_dp_forward`` of another version of
    ``lon_dp.cu`` against the tree's on every case ((what, the forward
    pass's arguments, mode, the reeval's trajectory or None)), every bit (a
    difference raises), timed in turns by events and from CUDA graphs.
    Returns the times of the case ``timed`` for the first parent, or
    None."""
    import torch
    from tpl_tpu_torch import _build

    stream = torch.cuda.current_stream().cuda_stream
    lib = tlk._kernel()
    res = None
    for k, csrc in enumerate(parents_with(parent_csrc, "lon_dp")):
        parent = _build.load("lon_dp", csrc).lon_dp_forward
        parent.restype = lib.lon_dp_forward.restype
        parent.argtypes = lib.lon_dp_forward.argtypes
        for what, a, mode, traj in cases:
            rows = a[0].shape[0] if mode == 0 else traj.shape[0]
            outs = [torch.empty((rows, 7), dtype=torch.float32,
                                device=a[0].device) for _ in range(2)]
            old = forward_launch(parent, a, outs[0], mode, traj)
            new = forward_launch(lib.lon_dp_forward, a, outs[1], mode, traj)
            raising(old)(stream)
            raising(new)(stream)
            torch.cuda.synchronize()
            if not torch.equal(outs[0], outs[1]):
                raise AssertionError(f"lon_dp_forward {what}: the result "
                                     "differs from the parent kernel's")
            t = timed_in_turns("lon_dp_forward", what + " (bits equal)",
                               csrc, old, new)
            if k == 0 and what == timed:
                res = t
    return res


def sweep_buffers(a):
    """The sweep's outputs for its arguments ``a`` (the wrapper's): (cd,
    tc, best, cost, the arrival counter), the counter zeroed."""
    import torch

    LD, SD, dev = a[6], a[7], a[0].device
    return (torch.empty((LD, SD), dtype=torch.float32, device=dev),
            torch.empty((LD, SD), dtype=torch.float64, device=dev),
            torch.empty((), dtype=torch.int64, device=dev),
            torch.empty((), dtype=torch.float32, device=dev),
            torch.zeros(1, dtype=torch.int32, device=dev))


def sweep_launch(lib, a, inv, bufs, two=False, sweep_only=False):
    """``launch(stream)`` of a library's bare launchers of the sweep and its
    selection on the wrapper's arguments ``a`` into ``bufs``
    (:func:`sweep_buffers`): the tree's one launch
    (``poly_lat_sweep_select``) or, with ``two``, a source's two
    (``poly_lat_sweep``, then ``poly_lat_select`` on the sweep's
    ``length_veh``; with ``sweep_only`` the first alone)."""
    from tpl_tpu_torch.planning.dyn_prog import poly_lat_kernel as plk

    occ, rl, step, pp, env, start, LD, SD, S = a
    cd, tc, best, cost, counter = bufs
    TE, SE, LE = occ.shape
    head = (occ.data_ptr(), rl.data_ptr(), step.data_ptr(), pp.data_ptr(),
            env.data_ptr(), start.data_ptr(), inv.data_ptr(), cd.data_ptr(),
            tc.data_ptr())
    tail = (LD, SD, S, TE, SE, LE, rl.shape[0])
    if sweep_only:
        return lambda s: lib.poly_lat_sweep(*head, *tail, s)
    if two:
        lv = pp.data_ptr() + 4 * plk.PL_PP_KEYS.index("length_veh")
        return lambda s: lib.poly_lat_sweep(*head, *tail, s) or \
            lib.poly_lat_select(cd.data_ptr(), tc.data_ptr(), lv,
                                best.data_ptr(), cost.data_ptr(), LD, SD, s)
    return lambda s: lib.poly_lat_sweep_select(
        *head, best.data_ptr(), cost.data_ptr(), counter.data_ptr(), *tail,
        s)


def sweep_check(plk, a, what, got=None):
    """The sweep and its selection on the card (``got``, else one launch
    now) against the plain versions: the collision distance bit for bit,
    the cost map's NaN entries where the plain version's are and the others
    within SWEEP_RTOL, the winner and its cost the plain selection's on the
    kernel's own maps.  Returns (max|cd kernel-plain|, max rel cost)."""
    import torch

    cd, tc, best, cost = got or plk.sweep_select(*a)
    cd_w, tc_w = plk.evaluate_reference(*a)
    nan = torch.isnan(tc_w)
    e = float(torch.max(torch.abs(cd - cd_w)))
    fin = ~nan
    rel = float(torch.max(torch.abs(tc - tc_w)[fin] / torch.clamp(
        torch.abs(tc_w[fin]), min=1e-300))) if bool(fin.any()) else 0.0
    i_lv = plk.PL_PP_KEYS.index("length_veh")
    want_b, want_c = plk.select_reference(cd.cpu(), tc.cpu(),
                                          a[3][i_lv].cpu(), a[6], a[7])
    if (e != 0.0 or rel > SWEEP_RTOL or tc.dtype != torch.float64
            or not torch.equal(torch.isnan(tc), nan)
            or int(best) != int(want_b) or float(cost) != float(want_c)):
        raise AssertionError(f"poly_lat_sweep_select {what}: kernel and "
                             f"plain differ (max|cd| {e:.3e}, max rel cost "
                             f"{rel:.3e}, winner {int(best)} / "
                             f"{int(want_b)}, cost {float(cost)} / "
                             f"{float(want_c)})")
    return e, rel


def sweep_parent_check(plk, cases, parent_csrc, timed):
    """With ``parent_csrc``: the sweep and selection of another version of
    ``poly_lat.cu`` against the tree's one launch on every case ((what, the
    wrapper's arguments)), timed in turns by events and from CUDA graphs.
    A source of two launches (``poly_lat_select``) is run as such; one that
    keeps the sweep's sums in the tree's order (it exports
    ``poly_lat_sweep_profile`` or is the one launch) must give the same
    bits, an earlier one the collision distance bit for bit and the cost
    within SWEEP_PARENT_RTOL; the winner and its cost must be the same
    (else it raises); a source of two launches also times its sweep alone
    from CUDA graphs.  Returns the times of the cases ``timed`` for the
    first parent ({what: times}), or None."""
    import ctypes
    import torch
    from tpl_tpu_torch import _build

    stream = torch.cuda.current_stream().cuda_stream
    lib = plk._kernel()
    res = None
    for k, csrc in enumerate(parents_with(parent_csrc, "poly_lat")):
        plib = _build.load("poly_lat", csrc)
        two = hasattr(plib, "poly_lat_select")
        if two:
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            plib.poly_lat_sweep.restype = i32
            plib.poly_lat_sweep.argtypes = [ptr] * 9 + [i32] * 7 + [ptr]
            plib.poly_lat_select.restype = i32
            plib.poly_lat_select.argtypes = [ptr] * 5 + [i32] * 2 + [ptr]
        else:
            fn = plib.poly_lat_sweep_select
            fn.restype = lib.poly_lat_sweep_select.restype
            fn.argtypes = lib.poly_lat_sweep_select.argtypes
        bits = not two or hasattr(plib, "poly_lat_sweep_profile")
        for what, a in cases:
            inv = plk._hermite_inv(a[0].device)
            bufs = [sweep_buffers(a) for _ in range(2)]
            old = sweep_launch(plib, a, inv, bufs[0], two=two)
            new = sweep_launch(lib, a, inv, bufs[1])
            raising(old)(stream)
            raising(new)(stream)
            torch.cuda.synchronize()
            (cd0, tc0, b0, c0, _), (cd1, tc1, b1, c1, _) = bufs
            rel = float(torch.max(torch.abs(tc1 - tc0) / torch.clamp(
                torch.abs(tc0), min=1e-300)))
            same = torch.equal(cd0, cd1) and (
                torch.equal(tc0, tc1) if bits else rel <= SWEEP_PARENT_RTOL)
            if not (same and torch.equal(b0, b1) and torch.equal(c0, c1)):
                raise AssertionError(
                    f"poly_lat_sweep_select {what}: the result differs from "
                    f"the parent kernel's (max rel cost {rel:.3e}, winner "
                    f"{int(b1)} / {int(b0)})")
            t = timed_in_turns(
                "poly_lat_sweep_select", f"{what} ("
                + ("cd, tc" if bits else f"cd bits, max rel cost {rel:.3e}")
                + ", winner and cost equal; the parent "
                + ("sweep + select" if two else "one launch") + ")", csrc,
                old, new)
            if two:
                t["parent_sweep_graph"] = graph_ms(raising(sweep_launch(
                    plib, a, inv, bufs[0], two=True, sweep_only=True)))
                print(f"poly_lat_sweep_select {what}: the parent's sweep "
                      f"alone from CUDA graphs {t['parent_sweep_graph']:.4f}"
                      " ms")
            if k == 0 and what in timed:
                res = res or {}
                res[what] = t
    return res


def forward_phase_line(tlk, what, a, mhz):
    """The forward pass's profiling instantiation on ``a``: the rows bit for
    bit the plain instantiation's; prints lane 0's us by phase (the steps'
    sums; the staging once) and per step; returns the us by phase."""
    import torch

    got, cyc = tlk.forward_profile(*a)
    if not torch.equal(got, tlk.forward(*a)):
        raise AssertionError(f"lon_dp_forward {what}: the profiling "
                             "instantiation differs")
    T = a[0].shape[0]
    us = {k: v / mhz for k, v in cyc.items()}
    print(f"phases lon_dp_forward ({what}, T={T}, SM {mhz:.0f} MHz; rows "
          f"bit-equal): lane 0's us, the staging once and the steps summed: "
          + ", ".join(f"{k} {v:.3f}" for k, v in us.items())
          + f"; a step {sum(us.values()) / T:.3f} (without the staging "
          f"{(sum(us.values()) - us['stage']) / T:.3f}); total "
          f"{sum(us.values()):.3f} us")
    return us


def sweep_phase_line(plk, what, a, mhz):
    """The sweep's profiling instantiation on ``a``: the results bit for
    bit the plain instantiation's; prints thread 0's us a block by phase
    (the selection's: the last block's) and returns them."""
    import torch

    *got, cyc = plk.sweep_profile(*a)
    if not all(torch.equal(x, y) for x, y in zip(got, plk.sweep_select(*a))):
        raise AssertionError(f"poly_lat_sweep_select {what}: the profiling "
                             "instantiation differs")
    blocks = a[6] * a[7]
    us = {k: v / (1 if k == "select" else blocks) / mhz
          for k, v in cyc.items()}
    print(f"phases poly_lat_sweep_select ({what}, {a[6]} x {a[7]} x {a[8]}, "
          f"SM {mhz:.0f} MHz; results bit-equal): thread 0's us a block, "
          "the selection's the last block's: "
          + ", ".join(f"{k} {v:.3f}" for k, v in us.items())
          + f"; total {sum(us.values()):.3f} us")
    return us


def dp_scene(T, S, L):
    """A straight road with a parked car and a slower leader for the DP
    lat/lon planner: (dist (T, S, L, 2), ref_line (500, 8)), float32."""
    dist = np.full((T, S, L, 2), 10000.0, np.float32)
    dist[..., 0] = 10000.0 + (S - np.arange(S))[None, :, None]
    mid = L // 2
    for t in range(T):
        lead = min(S - 1, int(30 + 7 * t))
        dist[t, :lead, max(mid - 2, 0):mid + 3, 0] = (
            lead - np.arange(lead))[:, None]
        park = min(S, 120)
        dist[t, :park, 1:max(2, L // 4), 0] = np.minimum(
            dist[t, :park, 1:max(2, L // 4), 0],
            (park - np.arange(park))[:, None])
    dist[:, :, [0, L - 1], 0] = 0.0
    rl = np.zeros((500, 8), np.float32)
    rl[:, 0] = np.arange(500) * 0.5
    rl[:, 4], rl[:, 5], rl[:, 6] = 14.0, 4.0, 4.0
    return dist, rl


def nan_rule_phase(tlk, lam, tllk, plk, dev, parent_csrc=None):
    """The NaN rule on the card: the lon backward slice (two slices from a
    next slice whose row S // 2 is NaN, ``lon_scene(41, 13, 5, 90, 5)``),
    the forward and reeval passes (slice 2 NaN at a index 1), the
    action-min (seeded 37 x 5 x 3, row 18 NaN) and the fused slice (the
    demo grid's slice T - 2, row S // 2 NaN), each with every channel NaN
    and with the cost alone, bit for bit against the plain versions on the
    CPU, NaN equal to NaN (raises otherwise).  Then a NaN in a value input,
    which the terms keep: the lon kernels with a NaN in the distance map or
    the path's v_max (``scenes.lon_nan_values``: the final slice and slice
    T - 2 from clean next slices, the forward pass and the reeval of the
    clean trajectory); the fused slice and the action-min on the demo grid's
    slice T - 2 with NaN cells in the DP distance map or NaN lane bounds;
    the sweep and its selection with NaN lane bounds
    (``scenes.poly_lat_nan_bounds``) at 1 x 20 and 21 x 13.  Last the
    selection's edges through the sweep's inputs at the same grids
    (``scenes.poly_lat_select_edge``), against the plain selection on the
    kernel's own maps and, where no NaN is met, against ``parent_csrc``'s
    sweep and selection."""
    import torch
    from tpl_tpu_torch.scenes import (NAN_VALUES, SELECT_EDGES,
                                      lon_nan_values, lon_nodes, lon_scene,
                                      poly_lat_nan_bounds, poly_lat_scene,
                                      poly_lat_select_edge)

    def same(got, want, what):
        np.testing.assert_array_equal(got.cpu().numpy(), want.numpy(),
                                      err_msg=what)
        return int(torch.isnan(want).any(-1).sum())

    def poison(a, channel):
        if channel == "all":
            a[...] = float("nan")
        else:
            a[..., 0] = float("nan")

    T, S, V, A, P = 5, 41, 13, 5, 90
    pp, path, dist, x0 = lon_scene(S, V, A, P, T, S + A)
    nodes = lon_nodes(pp, path, dist, T, S, V, A)
    cpu = tuple(torch.from_numpy(x) for x in (pp, path, dist))
    gpu = tuple(x.to(dev) for x in cpu)
    x0 = torch.from_numpy(x0)
    Td, Sd, DS, L = (DEMO_SPEC[k] for k in ("t_steps", "s_steps", "ds_steps",
                                            "l_steps"))
    d_dist, d_rl = dp_scene(Td, Sd, L)
    p = tllk.LatLonParams()
    solves = {}
    for d in ("cpu", dev):
        solve, _ = tllk.make_latlon_solver(DEMO_SPEC, d)
        dist_x, rl_t, step_t, pp_d = solve.prepare(d_dist, d_rl, 0.5,
                                                   p.packed())
        solves[d] = (solve, dist_x, rl_t, step_t, pp_d,
                     solve.action_tables(pp_d))
    for channel in ("all", "cost"):
        n = {}
        nxt = nodes[T - 1].clone()
        poison(nxt[S // 2], channel)
        n["lon_dp_backward"] = 0
        for i in (T - 2, T - 3):
            want = tlk.backward_slice_reference(nxt, *cpu, i, False)
            n["lon_dp_backward"] += same(
                tlk.backward_slice(nxt.to(dev), *gpu, i, False), want,
                f"lon_dp_backward NaN {channel} slice {i}")
            nxt = want
        bad = nodes.clone()
        poison(bad[2, :, :, 1], channel)
        n["lon_dp_forward"] = same(
            tlk.forward(bad.to(dev), *gpu, x0.to(dev)),
            tlk.forward_reference(bad, *cpu, x0), f"lon_dp_forward NaN "
            f"{channel}")
        traj = tlk.forward_reference(nodes, *cpu, x0)
        n["lon_dp_forward reeval"] = same(
            tlk.reeval_pass(bad.to(dev), *gpu, traj.to(dev)),
            tlk.reeval_reference(bad, *cpu, traj), f"lon_dp reeval NaN "
            f"{channel}")
        args, tb_cpu = seeded_slice(lam, tllk, "cpu",
                                    np.random.default_rng(37), 37, 5, 3)
        poison(args[0][18], channel)
        solve_s, _ = tllk.make_latlon_solver(
            dict(t_steps=4, s_steps=37, ds_steps=5, l_steps=3), dev)
        pp_s = tllk.unpack_pp(torch.from_numpy(p.packed()).to(dev))
        n["latlon_action_min"] = same(
            lam.action_min(*[a.to(dev) for a in args],
                           solve_s.action_tables(pp_s)),
            lam.action_min_reference(*args, tb_cpu),
            f"latlon_action_min NaN {channel}")
        solve, dist_x, rl_t, step_t, pp_d, tables = solves["cpu"]
        nxt = solve.final_slice(dist_x, rl_t, step_t, pp_d).clone()
        poison(nxt[Sd // 2], channel)
        solve_g, dist_g, rl_g, step_g, pp_g, tables_g = solves[dev]
        n["latlon_backward_slice"] = same(
            solve_g.backward_slice(nxt.to(dev), Td - 2, dist_g, rl_g, step_g,
                                   pp_g, tables_g),
            solve.backward_slice_reference(nxt, Td - 2, dist_x, rl_t, step_t,
                                           pp_d, tables),
            f"latlon_backward_slice NaN {channel}")
        print(f"NaN rule, {channel} channel{'s' if channel == 'all' else ''}"
              " NaN: bit-equal to the plain versions on the CPU (NaN equal to "
              "NaN); nodes with a NaN: "
              + ", ".join(f"{k} {v}" for k, v in n.items()))

    # a NaN in a value input
    traj = tlk.forward_reference(nodes, *cpu, x0)
    traj = torch.cat([traj, traj[-2:]])
    for where in NAN_VALUES:
        path_n, dist_n = lon_nan_values(path, dist, where)
        cpu_n = tuple(torch.from_numpy(x) for x in (pp, path_n, dist_n))
        gpu_n = tuple(x.to(dev) for x in cpu_n)
        n = {"lon_dp_backward": 0}
        for i, last in ((T - 1, True), (T - 2, False)):
            nxt = nodes[min(i + 1, T - 1)]
            n["lon_dp_backward"] += same(
                tlk.backward_slice(nxt.to(dev), *gpu_n, i, last),
                tlk.backward_slice_reference(nxt, *cpu_n, i, last),
                f"lon_dp_backward NaN {where} slice {i}")
        n["lon_dp_forward"] = same(
            tlk.forward(nodes.to(dev), *gpu_n, x0.to(dev)),
            tlk.forward_reference(nodes, *cpu_n, x0),
            f"lon_dp_forward NaN {where}")
        n["lon_dp_forward reeval"] = same(
            tlk.reeval_pass(nodes.to(dev), *gpu_n, traj.to(dev)),
            tlk.reeval_reference(nodes, *cpu_n, traj),
            f"lon_dp reeval NaN {where}")
        if min(n.values()) == 0:
            raise AssertionError(f"NaN {where}: a lon kernel met no NaN")
        print(f"NaN in {where}: the lon kernels bit-equal to the plain "
              "versions on the CPU (NaN equal to NaN); rows with a NaN: "
              + ", ".join(f"{k} {v}" for k, v in n.items()))
    solve, dist_x, rl_t, step_t, pp_d, tables = solves["cpu"]
    solve_g, _, _, step_g, pp_g, tables_g = solves[dev]
    nxt = solve.final_slice(dist_x, rl_t, step_t, pp_d)
    i = Td - 2
    for where in ("distance", "lane_bounds"):
        dist_n, rl_n = dist_x.clone(), rl_t.clone()
        if where == "distance":
            dist_n[i, 60:62, L // 2 + 1] = float("nan")
        else:
            rl_n[80:84, 5] = float("nan")
            rl_n[160:162, 6] = float("nan")
        n = {"latlon_backward_slice": same(
            solve_g.backward_slice(nxt.to(dev), i, dist_n.to(dev),
                                   rl_n.to(dev), step_g, pp_g, tables_g),
            solve.backward_slice_reference(nxt, i, dist_n, rl_n, step_t, pp_d,
                                           tables),
            f"latlon_backward_slice NaN {where}")}
        ins = solve.slice_inputs(i, dist_n, rl_n, step_t, pp_d)
        n["latlon_action_min"] = same(
            lam.action_min(nxt.to(dev), *[x.to(dev) for x in ins], tables_g),
            lam.action_min_reference(nxt, *ins, tables),
            f"latlon_action_min NaN {where}")
        if min(n.values()) == 0:
            raise AssertionError(f"NaN {where}: a DP kernel met no NaN")
        print(f"NaN in the DP {where.replace('_', ' ')}: the fused slice and "
              "the action-min bit-equal to the plain versions on the CPU "
              "(NaN equal to NaN); cells with a NaN: "
              + ", ".join(f"{k} {v}" for k, v in n.items()))
    for LD, SD in ((1, 20), (21, 13)):
        occ, rl, step, ppl, env, start = poly_lat_scene(LD, SD, 201,
                                                        LD + SD)
        a = tuple(torch.as_tensor(np.asarray(x)).to(dev) for x in (
            occ, poly_lat_nan_bounds(rl), np.array([step], np.float32), ppl,
            env, start)) + (LD, SD, 201)
        got = plk.sweep_select(*a)
        sweep_check(plk, a, f"NaN lane bounds {LD} x {SD}", got)
        n_nan = int(torch.isnan(got[1]).sum())
        if not 0 < n_nan < LD * SD:
            raise AssertionError(f"poly_lat_sweep_select NaN lane bounds "
                                 f"{LD} x {SD}: {n_nan} NaN costs")
        print(f"NaN lane bounds, poly_lat_sweep_select {LD} x {SD}: {n_nan} "
              f"of {LD * SD} costs NaN as in the plain version, cd bit-equal, "
              f"the winner {int(got[2])} and its cost the plain selection's")
    clean = []
    for LD, SD in ((1, 20), (21, 13)):
        base = poly_lat_scene(LD, SD, 201, LD + SD)
        init = min(LD // 2 + 1, LD - 1) * SD + SD - 1
        for case in SELECT_EDGES:
            occ, rl, step, ppl, env, start = poly_lat_select_edge(base, SD,
                                                                  case)
            a = tuple(torch.as_tensor(np.asarray(x)).to(dev) for x in (
                occ, rl, np.array([step], np.float32), ppl, env, start)) + (
                LD, SD, 201)
            what = f"selection edge {case} {LD} x {SD}"
            cd, tc, best, cost = got = plk.sweep_select(*a)
            sweep_check(plk, a, what, got)
            tc = tc.flatten()
            reached = {
                "empty": bool((cd == 1000.0).all()),
                "infeasible": bool((tc.float() >= 1e6).all()),
                "nan_init": bool(torch.isnan(tc[init]))
                and not bool(torch.isnan(tc).all()),
                "nan_all": bool(torch.isnan(tc).all()) and int(best) == init
                and float(cost) == float("inf")}[case]
            if not reached:
                raise AssertionError(f"poly_lat_sweep_select {what}: the "
                                     "scene missed its edge")
            print(f"poly_lat_sweep_select {what}: {int(torch.isnan(tc).sum())}"
                  f" NaN costs, {int((cd == 1000.0).sum())} tied cd = 1000; "
                  f"the winner {int(best)} (first update {init}) and its cost "
                  f"{float(cost)} the plain selection's on the kernel's maps")
            if case in ("empty", "infeasible"):
                clean.append((what, a))
    sweep_parent_check(plk, clean, parent_csrc, ())


def fas_seeded_phase(tlk, plk, dev, mhz, parent_csrc=None):
    """``--kernels-only``: the forward and reeval passes of a seeded solve
    at the demo width (A=20) and at A=7, and the sweep with its selection
    seeded at 1 x 20, 21 x 13 and 5 x 11, against the plain versions (the
    forward bit for bit, the sweep's cost to SWEEP_RTOL, the winner
    exactly) and (with ``parent_csrc``) another version's kernels, timed in
    turns; the two profiling
    instantiations' "phases" lines."""
    import torch
    from tpl_tpu_torch.scenes import LON_DEMO, lon_nodes, lon_scene, \
        lon_shifted_start, poly_lat_scene

    on = lambda *a: tuple(torch.as_tensor(np.asarray(x)).to(dev) for x in a)
    T, S, V, _, P = (LON_DEMO[k] for k in "TSVAP")
    fwd_cases = []
    for A in (20, 7):
        pp, path, dist, x0 = lon_scene(S, V, A, P, T, 5, demo=True)
        nodes = lon_nodes(pp, path, dist, T, S, V, A, dev=dev)
        a = (nodes,) + on(pp, path, dist, x0)
        # a replan's start: the previous plan's cost and constraint at its
        # head, which the last row must not take over
        a_shift = a[:4] + on(lon_shifted_start(x0))
        for what, b in (("", a), (", replan start", a_shift)):
            if not torch.equal(tlk.forward(*b).cpu(), tlk.forward_reference(
                    *(x.cpu() for x in b))):
                raise AssertionError(f"lon_dp_forward A={A}{what}: kernel "
                                     "and plain version on the CPU differ")
        trj = tlk.forward(*a).clone()
        trj[2:, tlk.LC_J] = a[1][tlk.LON_PP_KEYS.index("j_min")]
        trj = torch.cat([trj, trj[-3:]])
        fwd_cases += [(f"seeded forward (A={A})", a, 0, None),
                      (f"seeded reeval (A={A})", a, 1, trj),
                      (f"seeded forward, replan start (A={A})", a_shift, 0,
                       None)]
    print("lon_dp_forward: the seeded forward passes (A=20, A=7; from the "
          "scene's start and from a replan's) bit-equal to the plain "
          "version on the CPU")
    forward_parent_check(tlk, fwd_cases, parent_csrc, None)
    forward_phase_line(tlk, "seeded A=20", fwd_cases[0][1], mhz)
    sweep_cases = []
    for LD, SD in ((1, 20), (21, 13), (5, 11)):
        occ, rl, step, ppl, env, start = poly_lat_scene(LD, SD, 201,
                                                        LD + SD)
        a = on(occ, rl, np.array([step], np.float32), ppl, env, start) + (
            LD, SD, 201)
        sweep_check(plk, a, f"seeded {LD} x {SD}")
        sweep_cases.append((f"seeded {LD} x {SD}", a))
    print("poly_lat_sweep_select: the seeded sweeps (1 x 20, 21 x 13, "
          "5 x 11) against the plain versions: cd bit-equal, cost within "
          f"{SWEEP_RTOL}, the winner and its cost the plain selection's")
    sweep_parent_check(plk, sweep_cases, parent_csrc, ())
    sweep_phase_line(plk, "seeded 1 x 20", sweep_cases[0][1], mhz)


def fas_kernel_phase(tlk, plk, rmp, recs, dev, cycles, mhz,
                     parent_csrc=None):
    """The chain's kernels against their plain versions on the card, on
    seeded inputs at the demo width (lon T=10, S=201, V=37, A=20, P=200;
    the sweep at 1 x 20 and 21 x 13) and on the recorded inputs of each
    loop's first replan (``recs``: the FAS loop's under "fas", the lattice
    loop's under "lattice": lon A=20 and A=7, the sweep at 1 x 20 and
    21 x 13, the rampify start mode at the path step of each); the jerks of
    every lon slice as indices (the share of differing nodes bounded), the
    loops' first lon slice after the final one, forward pass and rampify
    scan also bit for bit against the plain versions on the CPU; the
    selection's winner exactly; the RSTP mode of the rampify source still
    bit for bit.  Times each entry through its bare launcher and its
    wrapper (in turns) and its plain version on the FAS loop's inputs, the
    wrapper on the lattice loop's, and prints ``bound_ms`` / ``chain_ms``.
    Returns one result dict per row: ``err`` / ``share`` the largest over
    the seeded and FAS-loop inputs, ``lattice_err`` / ``lattice_share``
    over the lattice loop's."""
    import torch
    from tpl_tpu_torch.scenes import (LON_DEMO, lon_nodes, lon_scene,
                                      lon_shifted_start, poly_lat_scene,
                                      rampify_args)

    on = lambda d, *a: tuple(torch.as_tensor(np.asarray(x)).to(d) for x in a)
    cpu = lambda a: tuple(x.cpu() if torch.is_tensor(x) else x for x in a)
    stream = torch.cuda.current_stream(dev).cuda_stream
    loops = ("fas", "lattice")
    res = {row: {} for row, _, _ in FAS_ROWS}

    def note(row, key, err):
        res[row][key] = max(res[row].get(key, 0.0), err)

    def key(loop, name="err"):
        return name if loop.startswith("seeded") or loop == "fas" \
            else f"lattice_{name}"

    # lon backward slice: seeded (every slice from the plain next slice)
    # and every slice of each loop's first solve, from its own next slice
    T, S, V, A, P = (LON_DEMO[k] for k in "TSVAP")
    pp, path, dist, x0 = lon_scene(S, V, A, P, T, 5, demo=True)
    args = on(dev, pp, path, dist)
    nodes = lon_nodes(pp, path, dist, T, S, V, A, dev=dev)
    slices = {"seeded": [(nodes[min(i + 1, T - 1)],) + args + (i, i == T - 1)
                         for i in range(T - 1, 0, -1)]}
    slices.update((loop, recs[loop]["lon_dp_backward"]) for loop in loops)
    for loop, cases in slices.items():
        for a in cases:
            e, share = lon_check(tlk.backward_slice(*a),
                                 tlk.backward_slice_reference(*a),
                                 f"{loop} slice {a[4]}")
            note("lon_dp_backward", key(loop), e)
            note("lon_dp_backward", key(loop, "share"), share)
        # every slice bit for bit against the plain version on the CPU
        lon_bits_on_cpu(tlk, cases, loop)
        r = res["lon_dp_backward"]
        print(f"lon_dp_backward check, {loop}: {len(cases)} slices at "
              f"{tuple(cases[0][0].shape[:3])}: max|kernel-plain| "
              f"{r[key(loop)]:.3e}, jerks differ on at most "
              f"{r[key(loop, 'share')]:.2e} of nodes; every slice "
              f"bit-equal to the plain version on the CPU")
    nxt, pp_r, path_r, dist_r, t_idx, _ = recs["fas"]["lon_dp_backward"][1]
    Tr = dist_r.shape[0]
    Sr, Vr, Ar = nxt.shape[:3]
    Pr = path_r.shape[0]
    out = torch.empty_like(nxt)
    lib = tlk._kernel()
    plan = lon_plan_line(tlk, pp_r, Sr, Vr, Ar, Pr, "FAS loop")
    ms, wrapper_ms = launcher_times(
        "lon_dp_backward", f"FAS loop slice {t_idx} ({Sr} x {Vr} x {Ar})",
        lambda: lib.lon_dp_backward(nxt.data_ptr(), pp_r.data_ptr(),
                                    path_r.data_ptr(), dist_r.data_ptr(),
                                    out.data_ptr(), Sr, Vr, Ar, Pr, t_idx, 0,
                                    plan["tile"], plan["box_cap"], stream),
        lambda: tlk.backward_slice(nxt, pp_r, path_r, dist_r, t_idx, False,
                                   out=out), 100)
    lat_a = recs["lattice"]["lon_dp_backward"][1]
    lon_plan_line(tlk, lat_a[1], *lat_a[0].shape[:3], lat_a[2].shape[0],
                  "lattice loop")
    lon_graph = {}
    for loop, a in (("fas", recs["fas"]["lon_dp_backward"][1]),
                    ("lattice", lat_a)):
        nxt_g, pp_g, path_g, dist_g, t_g, last_g = a
        out_g = torch.empty_like(nxt_g)
        head = (nxt_g.data_ptr(), pp_g.data_ptr(), path_g.data_ptr(),
                dist_g.data_ptr(), out_g.data_ptr(), *nxt_g.shape[:3],
                path_g.shape[0], int(t_g), int(bool(last_g)),
                *tlk._plan(pp_g, *nxt_g.shape[:3], path_g.shape[0]))
        lon_graph[loop] = graph_ms(lambda s: lib.lon_dp_backward(*head, s))
    print(f"lon_dp_backward from CUDA graphs (device time a launch): FAS "
          f"loop slice {t_idx} {lon_graph['fas']:.4f} ms, lattice loop "
          f"slice {lat_a[4]} {lon_graph['lattice']:.4f} ms")
    parent = lon_parent_check(
        tlk, [(f"{loop} slice {a[4]}", a) for loop, cases in slices.items()
              for a in cases], dev, parent_csrc,
        f"fas slice {t_idx}")
    res["lon_dp_backward"].update(
        plan=plan, parent=parent, graph_ms=lon_graph["fas"],
        lattice_graph_ms=lon_graph["lattice"],
        ms=ms, wrapper_ms=wrapper_ms,
        plain_ms=cuda_ms(lambda: tlk.backward_slice_reference(
            nxt, pp_r, path_r, dist_r, t_idx, False), 3),
        lattice_wrapper_ms=cuda_ms(lambda: tlk.backward_slice(*lat_a), 100),
        bound=tlk.bound_ms(Sr, Vr, Ar, Pr, Tr),
        chain=tlk.chain_ms(cycles, mhz))

    # lon forward pass and reeval (the trajectory's jerks set to j_min)
    solves = {"seeded": (nodes,) + args + on(dev, x0)}
    solves.update((loop, recs[loop]["lon_dp_forward"][0]) for loop in loops)
    # a replan's start: the previous plan's cost and constraint at its head
    solves["seeded, replan start"] = (nodes,) + args + on(
        dev, lon_shifted_start(x0))
    for loop, a in solves.items():
        got = tlk.forward(*a)
        note("lon_dp_forward", key(loop),
             float(torch.max(torch.abs(got - tlk.forward_reference(*a)))))
        traj = got.clone()
        traj[2:, tlk.LC_J] = a[1][tlk.LON_PP_KEYS.index("j_min")]
        b = a[:4] + (traj,)
        note("lon_dp_forward", key(loop), float(torch.max(torch.abs(
            tlk.reeval_pass(*b) - tlk.reeval_reference(*b)))))
        if loop != "seeded" and not torch.equal(
                got.cpu(), tlk.forward_reference(*cpu(a))):
            raise AssertionError(f"lon_dp_forward {loop}: kernel and plain "
                                 "version on the CPU differ")
        print(f"lon_dp_forward check, {loop} (A={a[0].shape[3]}): forward "
              f"and reeval max|kernel-plain| "
              f"{res['lon_dp_forward'][key(loop)]:.3e}"
              + ("" if loop == "seeded" else
                 "; the forward pass bit-equal to the plain version on "
                 "the CPU"))
    if max(res["lon_dp_forward"].values()) > TRAJ_ATOL:
        raise AssertionError("lon_dp_forward: kernel and plain differ")
    nodes_r, pp_r, path_r, dist_r, x0_r = recs["fas"]["lon_dp_forward"][0]
    Tr = nodes_r.shape[0]
    outf = torch.empty((Tr, 7), dtype=torch.float32, device=dev)

    def forward_bare(s=stream):
        return lib.lon_dp_forward(
            nodes_r.data_ptr(), pp_r.data_ptr(), path_r.data_ptr(),
            dist_r.data_ptr(), x0_r.data_ptr(), outf.data_ptr(), Tr, Sr, Vr,
            Ar, Pr, Tr, 0, s)

    ms, wrapper_ms = launcher_times(
        "lon_dp_forward", f"FAS loop solve (T={Tr}, {tlk.NF} jerks)",
        forward_bare,
        lambda: tlk.forward(nodes_r, pp_r, path_r, dist_r, x0_r), 100)
    res["lon_dp_forward"]["graph_ms"] = graph_ms(raising(forward_bare))
    traj = outf.clone()
    traj[2:, tlk.LC_J] = pp_r[tlk.LON_PP_KEYS.index("j_min")]
    reeval_ms = cuda_ms(lambda: tlk.reeval_pass(nodes_r, pp_r, path_r,
                                                dist_r, traj), 100)
    print(f"lon_dp_forward: reeval of {traj.shape[0]} rows through the "
          f"wrapper {reeval_ms:.4f} ms")
    fwd_cases = []
    for loop, a in solves.items():
        trj = tlk.forward(*a).clone()
        trj[2:, tlk.LC_J] = a[1][tlk.LON_PP_KEYS.index("j_min")]
        trj = torch.cat([trj, trj[-3:]])        # more rows than slices
        fwd_cases += [(f"{loop} forward (A={a[0].shape[3]})", a, 0, None),
                      (f"{loop} reeval (A={a[0].shape[3]})", a, 1, trj)]
    res["lon_dp_forward"]["parent"] = forward_parent_check(
        tlk, fwd_cases, parent_csrc, next(
            w for w, *_ in fwd_cases if w.startswith("fas forward")))
    res["lon_dp_forward"]["phases_us"] = forward_phase_line(
        tlk, "FAS loop solve", recs["fas"]["lon_dp_forward"][0], mhz)
    lat_a = recs["lattice"]["lon_dp_forward"][0]
    res["lon_dp_forward"].update(
        ms=ms, wrapper_ms=wrapper_ms,
        plain_ms=cuda_ms(lambda: tlk.forward_reference(
            nodes_r, pp_r, path_r, dist_r, x0_r), 2),
        lattice_wrapper_ms=cuda_ms(lambda: tlk.forward(*lat_a), 100),
        bound=tlk.forward_bound_ms(Sr, Vr, Ar, Pr, Tr),
        chain=tlk.forward_chain_ms(Tr, cycles, mhz), reeval_ms=reeval_ms)

    # the candidate sweep and its selection: seeded at 1 x 20 and 21 x 13,
    # and each loop's: the collision distance exactly, the float64 cost to
    # SWEEP_RTOL, the winner and its cost the plain selection's
    row = "poly_lat_sweep_select"
    cases = []
    for LD, SD in ((1, 20), (21, 13)):
        occ, rl, step, ppl, env, start = poly_lat_scene(LD, SD, 201,
                                                        LD + SD)
        cases.append(("seeded", on(dev, occ, rl, np.array([step], np.float32),
                                   ppl, env, start) + (LD, SD, 201)))
    cases += [(loop, recs[loop][row][0]) for loop in loops]
    for loop, a in cases:
        e, rel = sweep_check(plk, a, f"{loop} {a[6]} x {a[7]}")
        note(row, key(loop), e)
        note(row, key(loop, "cost_rel"), rel)
        print(f"poly_lat_sweep_select check, {loop} {a[6]} x {a[7]}: max|cd "
              f"kernel-plain| {e:.3e}, max rel cost {rel:.3e}, the plain "
              f"selection's winner and cost")
    sweep_cases = [(f"{loop} {a[6]} x {a[7]}", a) for loop, a in cases]
    a_fas, a_lat = recs["fas"][row][0], recs["lattice"][row][0]
    parent = sweep_parent_check(plk, sweep_cases, parent_csrc,
                                (sweep_cases[2][0], sweep_cases[3][0]))
    res[row]["parent"] = parent and {
        "fas": parent[sweep_cases[2][0]],
        "lattice": parent[sweep_cases[3][0]]}
    res[row]["phases_us"] = sweep_phase_line(plk, "FAS loop replan", a_fas,
                                             mhz)
    occ_r, rl_r, step_r, ppl_r, env_r, start_r, LD, SD, Sl = a_fas
    plib = plk._kernel()
    bare = raising(sweep_launch(plib, a_fas, plk._hermite_inv(dev),
                                sweep_buffers(a_fas)))
    ms, wrapper_ms = launcher_times(
        row, f"FAS loop replan ({LD} x {SD} x {Sl})", lambda: bare(stream),
        lambda: plk.sweep_select(*a_fas), 100)
    res[row]["graph_ms"] = graph_ms(bare)
    res[row]["lattice_graph_ms"] = graph_ms(raising(sweep_launch(
        plib, a_lat, plk._hermite_inv(dev), sweep_buffers(a_lat))))
    print(f"poly_lat_sweep_select from CUDA graphs (device time a launch): "
          f"FAS loop {LD} x {SD} {res[row]['graph_ms']:.4f} ms, lattice loop "
          f"{a_lat[6]} x {a_lat[7]} {res[row]['lattice_graph_ms']:.4f} ms")
    i_lv = plk.PL_PP_KEYS.index("length_veh")

    def plain(a):
        cd, tc = plk.evaluate_reference(*a)
        return plk.select_reference(cd, tc, a[3][i_lv], a[6], a[7])

    def updates(a):
        cd, tc = plk.sweep_select(*a)[:2]
        return plk.selection_updates(cd, tc, a[3][i_lv], a[6], a[7])

    def chain(a):
        return plk.sweep_select_chain_ms(a[6], a[7], a[8], updates(a), cycles,
                                         mhz)

    def bound(a):
        return plk.bound_ms(a[6], a[7], a[8], a[1].shape[0],
                            min(a[0].numel(), 9 * a[6] * a[7] * a[8]))

    res[row].update(
        ms=ms, wrapper_ms=wrapper_ms, plain_ms=cuda_ms(lambda: plain(a_fas),
                                                       3),
        lattice_wrapper_ms=cuda_ms(lambda: plk.sweep_select(*a_lat), 50),
        bound=bound(a_fas), chain=chain(a_fas),
        sweep_chain_ms=plk.chain_ms(Sl, cycles, mhz),
        lattice_bound_ms=bound(a_lat)[0], lattice_chain_ms=chain(a_lat),
        selection_updates={"fas": updates(a_fas), "lattice": updates(a_lat)})
    print(f"poly_lat_sweep_select: bound {res[row]['bound'][0]:.6f} ms "
          f"({res[row]['bound'][1]}), sweep_select_chain_ms "
          f"{res[row]['chain']:.6f} (the sweep's chain alone "
          f"{res[row]['sweep_chain_ms']:.6f}; {res[row]['selection_updates']}"
          f" selection updates), lattice bound "
          f"{res[row]['lattice_bound_ms']:.6f}, chain "
          f"{res[row]['lattice_chain_ms']:.6f}")

    # the rampify start mode (seeded, and each loop's at its path step), and
    # the RSTP mode of the same source, bit for bit
    ra = rampify_args(dev, 200, 200, 3)
    cases = [("seeded", (ra[2],) + ra[4:])]
    cases += [(loop, recs[loop]["rstp_rampify_start"][0]) for loop in loops]
    for loop, a in cases:
        got = rmp.scan_start(*a)
        want = rmp.scan_start_reference(*a)
        note("rstp_rampify_start", key(loop),
             float(torch.max(torch.abs(got - want))))
        if not (torch.equal(got, want) and (loop == "seeded" or torch.equal(
                got.cpu(), rmp.scan_start_reference(*cpu(a))))):
            raise AssertionError(f"rstp_rampify start mode {loop}: kernel "
                                 "and plain differ")
        print(f"rstp_rampify start mode check, {loop} (H={a[0].shape[0]}, "
              f"step {float(a[-1]):g}): bit-equal to the plain version"
              + ("" if loop == "seeded" else " on the card and the CPU"))
    if not torch.equal(rmp.scan(*ra), rmp.scan_reference(*ra)):
        raise AssertionError("rstp_rampify: the RSTP mode and its plain "
                             "version differ")
    print("rstp_rampify RSTP mode check: bit-equal to the plain version")
    loop_a = recs["fas"]["rstp_rampify_start"][0]
    lim_r = loop_a[0]
    H = lim_r.shape[0]
    ptrs = rmp.pointers((loop_a[1],) * 2 + loop_a[1:], lim_r)
    outr = torch.empty((H, 2), dtype=torch.float32, device=dev)
    rlib = rmp._kernel()
    ms, wrapper_ms = launcher_times(
        "rstp_rampify_start", f"FAS loop replan (H={H})",
        lambda: rlib.rstp_rampify_scan_start(ptrs, outr.data_ptr(), H,
                                             stream),
        lambda: rmp.scan_start(*loop_a), 200)
    lat_a = recs["lattice"]["rstp_rampify_start"][0]
    res["rstp_rampify_start"].update(
        ms=ms, wrapper_ms=wrapper_ms,
        plain_ms=cuda_ms(lambda: rmp.scan_start_reference(*loop_a), 2),
        lattice_wrapper_ms=cuda_ms(lambda: rmp.scan_start(*lat_a), 200),
        bound=rmp.bound_ms(H), chain=rmp.chain_ms(H, cycles, mhz))
    for row, r in res.items():
        print(f"{row}: kernel {r['ms']:.4f} ms (bare launcher; wrapper "
              f"{r['wrapper_ms']:.4f}"
              + (f"; from CUDA graphs {r['graph_ms']:.4f}"
                 if "graph_ms" in r else "") +
              f"; on the lattice loop's inputs "
              f"{r['lattice_wrapper_ms']:.4f}), plain {r['plain_ms']:.4f} "
              f"ms, bound_ms {r['bound'][0]:.6f} ({r['bound'][1]}), "
              f"chain_ms {r['chain']:.6f}; max|kernel-plain| {r['err']:.3e}"
              f", lattice loop {r['lattice_err']:.3e}")
    return res


def rollout_counts(idk, pok, reset=False):
    """The rollout planners' kernel launch counters (set to 0 with
    ``reset``)."""
    if reset:
        idk.rollout_launches = idk.evaluate_launches = 0
        pok.launches = 0
    return {"idm_rollout": idk.rollout_launches,
            "idm_evaluate": idk.evaluate_launches,
            "poly_sampling": pok.launches}


def rollout_loop_phase(idk, pok, name, ticks):
    """SimStandalone on the planner's demo scenario (``IDM`` on
    demo/country_overtake, ``POLY`` on demo/country_follow) with that
    planner active and the scenario's other sets, the launch counters set
    to 0 just before the loop and read just after.  Checks zero rule
    violations, no emergency plan, finite controls and the planner's
    kernels launched exactly as often per replan as a replan launches them
    (IDM: one rollout and one evaluation; poly: the grid's one launch)
    and the other planner's not at all; prints the end state beside the JAX
    package's CPU loop's and the per-replan wall.  Returns the first
    replan's inputs."""
    import torch
    from tpl_tpu_torch.simulation import SimStandalone

    scenario, jt, jx, jv = ROLLOUT_JAX_END[name]
    sim = SimStandalone(app_id=f"smoke_{name}", scenario_path=scenario)
    store = sim.planning_app.sh_planners
    with store.lock():
        store.active_planner = name
    planner = sim.planning_app.planners[name]
    controllers = sim.control_app.sh_controllers
    with sim.core.sh_state.lock():
        ss = sim.core.sh_state.sim
        ss.settings.running = True
        ss.settings.use_real_time = False
        ss.rule_checker.enable = True
    tick_ms, replan_ms, first = [], [], None
    last = planner.last_update_time
    rollout_counts(idk, pok, reset=True)
    for k in range(ticks):
        t0 = time.perf_counter()
        sim.update()
        torch.cuda.synchronize()
        tick_ms.append((time.perf_counter() - t0) * 1e3)
        if planner.last_update_time != last:
            last = planner.last_update_time
            replan_ms.append(planner.runtime_planning)
            if first is None:
                first = planner.last_inputs
        with store.lock():
            emergency = store.trajectory.emergency
        with controllers.lock():
            controls = np.array(controllers.controls)
        if emergency:
            raise AssertionError(f"{name} tick {k}: emergency trajectory")
        if not np.all(np.isfinite(controls)):
            raise AssertionError(f"{name} tick {k}: non-finite controls")
    counts = rollout_counts(idk, pok)
    n = len(replan_ms)
    if name == IDM:
        per_replan = {"idm_rollout": 1, "idm_evaluate": 1, "poly_sampling": 0}
    else:
        per_replan = {"idm_rollout": 0, "idm_evaluate": 0, "poly_sampling": 1}
    for row, per in per_replan.items():
        if n == 0 or counts[row] != per * n:
            raise AssertionError(f"{name}: {counts[row]} {row} launches for "
                                 f"{n} replans")
    with sim.core.sh_state.lock():
        s = sim.core.sh_state.sim
        violations = list(s.rule_checker.violations)
        t_end, x_end, v_end = s.t, s.ego.x, s.ego.v
    if violations:
        raise AssertionError(f"{name}: rule violations {violations[:3]}")
    if not v_end > 4.0:
        raise AssertionError(f"{name}: ego speed {v_end} at the end")
    print(f"{name} on {scenario}: {ticks} ticks to t={t_end:.2f} s, ego x "
          f"{x_end:.3f} v {v_end:.3f} m/s (the JAX package's CPU loop: "
          f"t={jt:.2f} s, x {jx:.3f} v {jv:.3f}), 0 violations, no "
          f"emergency, {n} replans; launches per replan (per tick): "
          + ", ".join(f"{r} {p} ({counts[r] / ticks:g})"
                      for r, p in per_replan.items() if p))
    print(f"{name}: per-replan wall ms: median {np.median(replan_ms):.3f}, "
          f"max {np.max(replan_ms):.3f} (first {replan_ms[0]:.3f}); per-tick "
          f"total wall ms: median {np.median(tick_ms):.3f}, max "
          f"{np.max(tick_ms):.3f}")
    return dict(counts=counts, replans=n, ticks=ticks, first=first,
                replan_ms=replan_ms, end=(t_end, x_end, v_end))


def _first_min(costs):
    """The hierarchical minimum of the IDM selection (a fresh selection
    state: no hysteresis), on the (5, C) costs."""
    from tpl_tpu_torch.planning.idm_sampling import idm_kernel as idk
    from tpl_tpu_torch.planning.idm_sampling.idm_sampling_planner import \
        IdmSamplingPlanner
    import types

    state = types.SimpleNamespace(i_prev=-1, i_min_prev=0, t_decision=0.0)
    return IdmSamplingPlanner._select(
        state, idk.costs_dict(np.asarray(costs, np.float64)), 0.05,
        types.SimpleNamespace(dt_decision=0.5))


def plain_timed(fn):
    """(fn(), its ms by CUDA events): one call, no warm-up."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def idm_compare(idk, what, args, T, lg, refs=None, cons=None, keep=False):
    """The IDM kernels against their plain versions on the card on one
    scene, every candidate: the rollout (unless ``refs`` / ``cons`` are
    given: the evaluation alone on them) and the evaluation of the kernel's
    rollout.  Raises on a candidate past IDM_TOL or a flipped ``invalid``;
    prints the largest differences, the hull tests the evaluation's gates
    let through (collision, interaction: :func:`idm_kernel.evaluate_work`),
    the candidates with an interaction cost and whether the selection
    flipped.  Returns (max rollout err, max evaluation err, selection
    flipped, plain rollout ms, plain evaluation ms, (n_coll, n_inter,
    n_proj), the kernel's costs (5, C)) and, with ``keep``, the plain
    rollout (ref_states, states)."""
    import torch

    e_roll, ms_roll, past = 0.0, None, None
    if refs is None:
        refs, cons = idk.rollout(*args, T)
        want, ms_roll = plain_timed(lambda: idk.rollout_reference(
            *args[:4], args[4][0], args[5], args[6][0], args[7], args[8], T))
        for g, w in zip((refs, cons), want):
            d = torch.abs(g - w)
            e_roll = max(e_roll, float(d.max()))
            bad = (d > IDM_TOL + IDM_TOL * torch.abs(w)).flatten(1).any(1)
            past = bad if past is None else past | bad
        if not keep:
            del want
    costs = idk.evaluate(refs, cons, args[2], args[7], args[5], args[6],
                         args[8], lg)
    want_c, ms_eval = plain_timed(lambda: idk.evaluate_reference(
        refs, cons, args[2], args[7], args[5], args[6][0], args[8], lg[0]))
    d = torch.abs(costs - want_c)
    e_eval = float(d.max())
    bad = (d > IDM_TOL + IDM_TOL * torch.abs(want_c)).any(0)
    past = bad if past is None else past | bad
    n_past = int(past.sum())
    flips = int((costs[4] != want_c[4]).sum())
    work = idk.evaluate_work(cons, args[7], args[8], projections=True)
    n_int = int((costs[2] > 0).sum())
    sel_k, sel_p = _first_min(costs.cpu()), _first_min(want_c.cpu())
    print(f"idm check, {what} ({costs.shape[1]} candidates of {T} steps): "
          f"max|kernel-plain| rollout {e_roll:.3e}, evaluation "
          f"{e_eval:.3e}; {n_past} candidates past rtol = atol = "
          f"{IDM_TOL:g}; invalid flipped on {flips}; the gates let "
          f"{work[0]} collision and {work[1]} interaction hull tests and "
          f"{work[2]} of {costs.shape[1] * T * args[7]['valid'].shape[0]} "
          f"path projections through, {n_int} candidates with an "
          f"interaction cost, "
          f"{int(costs[4].sum())} invalid; selection kernel {sel_k}, plain "
          f"{sel_p}" + (" (FLIPPED: a near tie)" if sel_k != sel_p else ""))
    if n_past or flips:
        raise AssertionError(f"idm {what}: kernels and plain versions differ")
    res = (e_roll, e_eval, sel_k != sel_p, ms_roll, ms_eval, work, costs)
    return res + (want,) if keep else res


def ptxas_usage(name):
    """(registers a thread, spill stores + loads in bytes) of a kernel
    library built from csrc/, from its ptxas report, or (None, None)."""
    from tpl_tpu_torch import _build

    log = _build.BUILD_LOG.get(name, "")
    regs = re.findall(r"Used (\d+) registers", log)
    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                        log)
    if not regs:
        return None, None
    return (max(int(r) for r in regs),
            sum(int(a) + int(b) for a, b in spills))


def idm_parent_cases(idk, scenes, dev):
    """The ``compare_with_parent`` cases of the IDM kernels on ``scenes``
    ((what, args, T, lg), the rollout's arguments): the rollout into one
    buffer (the ref states, then the states), the evaluation of the tree
    kernel's rollout."""
    import torch

    lib = idk._kernel()
    stream = torch.cuda.current_stream(dev).cuda_stream
    roll, ev = [], []
    for what, a, T, lg in scenes:
        C = a[2].shape[0]
        NR, OPK = a[5].shape[0], a[7]["hull_preds"].shape[:3]
        optrs = [a[7][k].data_ptr() for k in idk.OBJ_KEYS]
        like = torch.empty(C * T * 19, dtype=torch.float32, device=dev)

        def r_call(fn, out, a=a, C=C, T=T, NR=NR, OPK=OPK, optrs=optrs):
            return fn(*(x.data_ptr() for x in a[:7]), *optrs, a[8].data_ptr(),
                      out.data_ptr(), out.data_ptr() + C * T * 10 * 4, C, T,
                      NR, *OPK, stream)
        refs, cons = idk.rollout(*a, T)
        costs = torch.empty((5, C), dtype=torch.float32, device=dev)

        def e_call(fn, out, a=a, C=C, T=T, NR=NR, OPK=OPK, optrs=optrs,
                   refs=refs, cons=cons, lg=lg):
            return fn(refs.data_ptr(), cons.data_ptr(), a[2].data_ptr(),
                      *optrs, a[5].data_ptr(), a[6].data_ptr(),
                      a[8].data_ptr(), lg.data_ptr(), out.data_ptr(), C, T,
                      NR, *OPK, stream)
        roll.append((f"{what} (C={C}, T={T})", like, r_call))
        ev.append((f"{what} (C={C}, T={T})", costs, e_call))
    return {"idm_rollout": (lib.idm_rollout, roll),
            "idm_evaluate": (lib.idm_evaluate, ev)}


def idm_kernel_phase(idk, first, dev, cycles, mhz, parent_csrc=None):
    """The IDM kernels against their plain versions on the card, every
    candidate: the seeded scenes of tests/test_idm_kernel.py (the stop
    cell, off-road excursions to +-5 m, the parked collider with
    trajectories driven through it), an oncoming car (the interaction
    screen's hull tests must run and hit), the hairpin scene (a ref line
    that doubles back: the exact searches must decide), the loop's first
    replan (C=8) and the JAX bench's scene at its full width (C=16,384);
    times both kernels through the bare launcher and the wrapper in turns
    at C=16,384 and C=8, the plain versions at C=16,384 (the compared run);
    rollouts/s, blocks an SM, registers a thread, the full-scan and the
    needed-work ``bound_ms`` and ``chain_ms``; and (with ``parent_csrc``)
    both kernels against another version of their sources on the bench,
    the loop's first replan, the seeded scenes and the hairpin, bit for
    bit, in turns."""
    import torch
    from tpl_tpu_torch.scenes import (idm_args, idm_bench_scene,
                                      idm_hairpin_scene, idm_scene,
                                      idm_through_states)

    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    lg0 = torch.zeros(1, dtype=torch.float32, device=dev)
    res = {"idm_rollout": {"err": 0.0}, "idm_evaluate": {"err": 0.0}}
    flips = []
    parent_scenes = []

    def note(r):
        res["idm_rollout"]["err"] = max(res["idm_rollout"]["err"], r[0])
        res["idm_evaluate"]["err"] = max(res["idm_evaluate"]["err"], r[1])
        flips.append(r[2])
        return r

    for what, scene, kw, C, T, lt in (
            ("stop cell", idm_scene, dict(stop_cell=True), 48, 30, 5),
            ("off-road", idm_scene, dict(), 13, 100, 5),
            ("hairpin", idm_hairpin_scene, dict(), 8, 100, 5),
            ("hairpin", idm_hairpin_scene, dict(), 256, 100, 5),
            ("oncoming car", idm_scene, dict(oncoming=True), 256, 100, 5)):
        rl, objs, pp, ir, ic = scene(**kw)
        l_trgs = np.linspace(-lt, lt, C).astype(np.float32)
        d_stops = np.where(np.arange(C) % 3 == 0, 30.0, 1e6).astype(
            np.float32)
        a = idm_args(rl, objs, pp, ir, ic, l_trgs, d_stops, dev)
        r = note(idm_compare(idk, what, a, T, lg0))
        parent_scenes.append((what, a, T, lg0))
        if what == "hairpin" and not (r[5][1] > 0 and r[5][2] > 0):
            raise AssertionError("idm hairpin: no interaction hull test or "
                                 "path projection ran")
    if not (r[5][1] > 0 and bool((r[6][2] > 0).any())):
        raise AssertionError("idm oncoming car: no interaction hull test "
                             "hit")
    rl, objs, pp, ir, ic = idm_scene(collider=True)
    refs, cons = (torch.from_numpy(a).to(dev)
                  for a in idm_through_states(64, 20))
    a = idm_args(rl, objs, pp, ir, ic, np.linspace(-3, 3, 64), np.zeros(64),
                 dev)
    r = note(idm_compare(idk, "parked collider", a, 20, lg0, refs, cons))
    if not bool(r[6][4].any()):
        raise AssertionError("idm parked collider: no candidate collides")

    # the loop's first replan
    loop_a = (f32(first["init_ref"]), f32(first["init_con"]),
              f32(first["l_trgs"]), f32(first["d_stops"]),
              f32([first["dt_replan"]]), f32(first["ref_line"]),
              f32([first["ref_step"]]), idk.objs_to_torch(first["objs"], dev),
              f32(first["pp"]))
    loop_T, loop_lg = first["T"], f32([first["l_trg_global"]])
    note(idm_compare(idk, "the loop's first replan", loop_a, loop_T, loop_lg))
    parent_scenes.append(("the loop's first replan", loop_a, loop_T,
                          loop_lg))

    # the JAX bench's scene at its full width (the plain versions' times)
    rl, objs, pp, ir, ic, l_trgs, d_stops = idm_bench_scene(IDM_C)
    T = 100
    big = idm_args(rl, objs, pp, ir, ic, l_trgs, d_stops, dev)
    _, _, _, plain_roll, plain_eval, (n_coll, n_inter, n_proj), _, \
        (p_refs, p_cons) = note(idm_compare(idk, "the JAX bench's scene",
                                            big, T, lg0, keep=True))
    parent_scenes.append(("the JAX bench's scene", big, T, lg0))
    work = idk.rollout_work(p_refs, p_cons, big[5], big[6][0], big[8])
    del p_refs, p_cons

    lib = idk._kernel()
    stream = torch.cuda.current_stream(dev).cuda_stream
    NR, (O, P, K) = rl.shape[0], objs["hull_preds"].shape[:3]

    def bare(a, C, T, out_r, out_c, lg, out_e):
        optrs = [a[7][k].data_ptr() for k in idk.OBJ_KEYS]

        def rollout():
            return lib.idm_rollout(*(x.data_ptr() for x in a[:7]), *optrs,
                                   a[8].data_ptr(), out_r.data_ptr(),
                                   out_c.data_ptr(), C, T, a[5].shape[0], *(
                                       a[7]["hull_preds"].shape[:3]), stream)

        def evaluate():
            return lib.idm_evaluate(out_r.data_ptr(), out_c.data_ptr(),
                                    a[2].data_ptr(), *optrs, a[5].data_ptr(),
                                    a[6].data_ptr(), a[8].data_ptr(),
                                    lg.data_ptr(), out_e.data_ptr(), C, T,
                                    a[5].shape[0],
                                    *a[7]["hull_preds"].shape[:3], stream)
        return rollout, evaluate

    times = {}
    for tag, a, C, Tt, lg, n in (("full", big, IDM_C, T, lg0, 10),
                                 ("loop", loop_a, len(first["l_trgs"]),
                                  loop_T, loop_lg, 200)):
        out_r = torch.empty((C, Tt, 10), dtype=torch.float32, device=dev)
        out_c = torch.empty((C, Tt, 9), dtype=torch.float32, device=dev)
        out_e = torch.empty((5, C), dtype=torch.float32, device=dev)
        b_roll, b_eval = bare(a, C, Tt, out_r, out_c, lg, out_e)
        times[tag] = (
            launcher_times("idm_rollout", f"{tag} (C={C}, T={Tt})", b_roll,
                           lambda: idk.rollout(*a, Tt, out=(out_r, out_c)),
                           n),
            launcher_times("idm_evaluate", f"{tag} (C={C}, T={Tt})", b_eval,
                           lambda: idk.evaluate(out_r, out_c, a[2], a[7],
                                                a[5], a[6], a[8], lg,
                                                out=out_e), n))
    split = {C: bool(lib.rollout_lib.idm_rollout_split(C))
             for C in (len(first["l_trgs"]), IDM_C)}
    occupancy = (lib.idm_rollout_blocks_per_sm(NR, O, P, K),
                 lib.idm_evaluate_blocks_per_sm(T, O, P, K))
    usage = (ptxas_usage("idm_rollout"), ptxas_usage("idm_evaluate"))
    print(f"idm blocks of 256 threads per SM at NR={NR}, O={O}, P={P}, "
          f"K={K}, T={T}: rollout {occupancy[0]} (8 candidates a block, "
          f"or 4 of two warps each; two warps a candidate at C = "
          f"{', '.join(f'{c}: {v}' for c, v in split.items())}), "
          f"evaluation {occupancy[1]} (persistent, batches of up to 16 "
          f"candidates); registers a thread (spilled bytes): rollout "
          f"{usage[0][0]} ({usage[0][1]}), evaluation {usage[1][0]} "
          f"({usage[1][1]})")
    (r_ms, r_wms), (e_ms, e_wms) = times["full"]
    rate = IDM_C / (r_ms + e_ms) * 1e3
    res["idm_rollout"].update(
        ms=r_ms, wrapper_ms=r_wms, plain_ms=plain_roll,
        loop_ms=times["loop"][0][0], loop_wrapper_ms=times["loop"][0][1],
        bound=idk.rollout_bound_ms(IDM_C, T, NR, O, P, K, work),
        full_scan_bound=idk.rollout_bound_ms(IDM_C, T, NR, O, P, K),
        chain=idk.rollout_chain_ms(T, cycles, mhz),
        blocks_per_sm=occupancy[0], registers=usage[0][0],
        spill_bytes=usage[0][1], work=work)
    res["idm_evaluate"].update(
        ms=e_ms, wrapper_ms=e_wms, plain_ms=plain_eval,
        loop_ms=times["loop"][1][0], loop_wrapper_ms=times["loop"][1][1],
        bound=idk.evaluate_bound_ms(IDM_C, T, NR, O, P, K, n_coll, n_inter,
                                    n_proj),
        full_scan_bound=idk.evaluate_bound_ms(IDM_C, T, NR, O, P, K, n_coll,
                                              n_inter),
        chain=idk.evaluate_chain_ms(T, O, cycles, mhz),
        blocks_per_sm=occupancy[1], registers=usage[1][0],
        spill_bytes=usage[1][1],
        work=dict(collision_tests=n_coll, interaction_tests=n_inter,
                  projections=n_proj))
    for row, r in res.items():
        r.update(selection_flips=sum(flips), rollouts_per_s=rate)
        print(f"{row}: kernel {r['ms']:.4f} ms at C={IDM_C} (bare launcher; "
              f"wrapper {r['wrapper_ms']:.4f}; {r['loop_ms']:.4f} at the "
              f"loop's C={len(first['l_trgs'])}), plain {r['plain_ms']:.2f} "
              f"ms at C={IDM_C}, bound_ms {r['bound'][0]:.6f} "
              f"({r['bound'][1]}, the work these inputs need: {r['work']}), "
              f"full-scan bound_ms {r['full_scan_bound'][0]:.6f} "
              f"({r['full_scan_bound'][1]}), chain_ms {r['chain']:.6f}; max"
              f"|kernel-plain| {r['err']:.3e}")
    print(f"idm rollouts/s at C={IDM_C}, T={T}: {rate:.0f} (C over the two "
          f"kernels' bare-launcher ms {r_ms:.4f} + {e_ms:.4f}); the "
          f"evaluation's gates let {n_coll} collision and {n_inter} "
          f"interaction hull tests and {n_proj} path projections through "
          f"of {IDM_C * T * O} each; selection flips {sum(flips)} of "
          f"{len(flips)} scenes")

    # the sources against another version of them, bit for bit, in turns
    for source, (fn, cases) in (idm_parent_cases(idk, parent_scenes, dev)
                                if parents_with(parent_csrc, "idm_rollout")
                                or parents_with(parent_csrc, "idm_evaluate")
                                else {}).items():
        for csrc in parents_with(parent_csrc, source):
            compare_with_parent(source, fn, csrc, cases)
    return res


def poly_cases(psp, pok, first, dev):
    """The poly grid's cases: (what, inputs on ``dev``, NaN costs
    expected, the scene for the numpy oracle or None): the JAX bench's
    scene (C=30, 500 path points, 8 obstacles), tests/test_poly_kernel.py's
    two scenes, the loop's first replan, and on the bench's scene a NaN cost
    at index 17, NaN costs at 23 and 9 (their end offsets NaN) and an exact
    tie of the least cost (the plain winner's (d, T, v) copied to the last
    candidate)."""
    from tpl_tpu_torch.scenes import poly_scene

    cases = [(what, psp.device_inputs(*case, dev), False, case)
             for what, case in (
                 ("the JAX bench's scene", poly_scene(bench=True)),
                 ("obstacles", poly_scene()),
                 ("free", poly_scene(obstacles=False)),
                 ("the loop's first replan", first))]
    bench = cases[0][1]
    for what, nan_at in (("NaN cost at 17", (17,)),
                         ("NaN costs at 23 and 9", (23, 9)),
                         ("a tie of the least cost", ())):
        a = [x.clone() for x in bench]
        if not nan_at:
            b = int(pok.run_reference(*a)[2])
            for i in (1, 2, 3):
                a[i][a[1].shape[0] - 1] = a[i][b]
        for j in nan_at:
            a[1][j] = float("nan")
        cases.append((f"the bench's scene, {what}", tuple(a), bool(nan_at),
                      None))
    return cases


def poly_buffers(a, dev):
    """The grid's scratch and outputs for inputs ``a``: (rows, costs,
    packed, cost, best, counter)."""
    import torch

    C, N = a[1].shape[0], a[4].shape[0]
    f64 = torch.float64
    return (torch.empty((C, 11, N), dtype=f64, device=dev),
            torch.empty(C, dtype=f64, device=dev),
            torch.empty((11, N), dtype=f64, device=dev),
            torch.empty((), dtype=f64, device=dev),
            torch.empty((), dtype=torch.int64, device=dev),
            torch.zeros(1, dtype=torch.int32, device=dev))


def poly_launch(lib, a, inv, bufs, stream, two=False):
    """The grid through a library's bare launcher into ``bufs``
    (:func:`poly_buffers`): the tree's one launch or, with ``two``, a
    source's two (``poly_sampling_eval``, ``poly_sampling_select``).
    Returns the CUDA error code."""
    rows, costs, packed, cost, best, counter = bufs
    C, N, n_path = a[1].shape[0], a[4].shape[0], a[5].shape[0]
    O, K = a[6].shape[:2]
    head = [x.data_ptr() for x in a] + [inv.data_ptr(), rows.data_ptr(),
                                        costs.data_ptr()]
    if two:
        e = lib.poly_sampling_eval(*head, C, N, n_path, O, K, stream)
        return e or lib.poly_sampling_select(
            rows.data_ptr(), costs.data_ptr(), packed.data_ptr(),
            cost.data_ptr(), best.data_ptr(), C, N, stream)
    return lib.poly_sampling(*head, packed.data_ptr(), cost.data_ptr(),
                             best.data_ptr(), counter.data_ptr(), C, N,
                             n_path, O, K, stream)


def nan_equal(a, b):
    """Bit for bit, NaN equal to NaN (both tensors of one dtype)."""
    import torch

    return bool(torch.equal(torch.isnan(a), torch.isnan(b))
                and torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)))


def poly_parent_check(pok, cases, dev, parent_csrc):
    """With ``parent_csrc``: another version of ``poly_sampling.cu`` (the
    two-launch design is recognised by its ``poly_sampling_eval``) against
    the tree's one launch on every case, through the bare launchers: every
    candidate's rows and cost bit for bit, and the winner's on every case
    without a NaN cost (a difference raises; the winners printed); times
    in turns (parent, tree, tree, parent) on the bench's scene by CUDA
    events and from CUDA graphs.  Returns {"events": ..., "graph": ...} of
    the first parent, or None."""
    import ctypes
    import torch
    from tpl_tpu_torch import _build

    lib = pok._kernel()
    stream = torch.cuda.current_stream(dev).cuda_stream
    inv = pok._inverses(dev)
    res = None
    for csrc in parents_with(parent_csrc, "poly_sampling"):
        plib = _build.load("poly_sampling", csrc)
        two = not hasattr(plib, "poly_sampling")
        if two:
            plib.poly_sampling_eval.restype = ctypes.c_int
            plib.poly_sampling_eval.argtypes = (
                [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5
                + [ctypes.c_void_p])
            plib.poly_sampling_select.restype = ctypes.c_int
            plib.poly_sampling_select.argtypes = (
                [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
                + [ctypes.c_void_p])
        else:
            plib.poly_sampling.restype = ctypes.c_int
            plib.poly_sampling.argtypes = lib.poly_sampling.argtypes
        for what, a, has_nan, _ in cases:
            old, new = poly_buffers(a, dev), poly_buffers(a, dev)
            for lb, bufs, t in ((plib, old, two), (lib, new, False)):
                if poly_launch(lb, a, inv, bufs, stream, t):
                    raise RuntimeError("poly_sampling launch failed")
            torch.cuda.synchronize()
            grid = nan_equal(old[0], new[0]) and nan_equal(old[1], new[1])
            pick = (nan_equal(old[2], new[2]) and nan_equal(old[3], new[3])
                    and int(old[4]) == int(new[4]))
            print(f"poly_sampling {what} vs the source in {csrc}: every "
                  f"candidate's rows and cost "
                  f"{'bit-equal' if grid else 'DIFFER'}, the winner's "
                  f"{'bit-equal' if pick else 'differ'}: parent "
                  f"{int(old[4])} (cost {float(old[3])}), new {int(new[4])} "
                  f"(cost {float(new[3])})")
            if not grid or not (pick or has_nan):
                raise AssertionError(f"poly_sampling {what}: the result "
                                     "differs from the parent kernel's")
        a = cases[0][1]
        old, new = poly_buffers(a, dev), poly_buffers(a, dev)

        def launcher(lb, bufs, t):
            return lambda s=stream: poly_launch(lb, a, inv, bufs, s, t)

        p_run = raising(launcher(plib, old, two))
        n_run = raising(launcher(lib, new, False))
        (ea, ed), (eb, ec) = in_turns(lambda: p_run(stream),
                                      lambda: n_run(stream), 200)
        graph = in_turns_graph(p_run, n_run)
        print(f"poly_sampling the JAX bench's scene vs the source in {csrc}: "
              f"ms parent {ea:.4f}, new {eb:.4f}, new {ec:.4f}, parent "
              f"{ed:.4f}; from CUDA graphs parent {graph[0]:.4f}, new "
              f"{graph[1]:.4f}, new {graph[2]:.4f}, parent {graph[3]:.4f}")
        if res is None:
            res = {"events": (ea, eb, ec, ed), "graph": graph}
    return res


def poly_kernel_phase(pok, psp, first, dev, cycles, mhz, parent_csrc=None):
    """The poly-sampling kernel against its plain version on the card and
    the numpy oracle ``_eval_candidates`` on the cases of
    :func:`poly_cases`: the winner's index equal to the plain version's
    (the oracle's on the cases without a NaN or a tie), its rows to
    POLY_ROW_TOL (plain) and POLY_ORACLE_TOL (oracle), NaN equal to NaN;
    the profiling instantiation bit-equal on every case, a "phases" line on
    the bench's scene.  Times the launch through the bare launcher and the
    wrapper in turns and from CUDA graphs on the bench's scene, the plain
    version, ``bound_ms`` and ``chain_ms`` (the one launch's and the
    earlier two launches' pricing); with ``parent_csrc``
    (:func:`poly_parent_check`) holds another version to the tree's."""
    import torch

    cases = poly_cases(psp, pok, first, dev)
    err, phases = 0.0, None
    for what, a, has_nan, scene in cases:
        packed, cost, best = pok.run(*a)
        want_p, want_c, want_b = pok.run_reference(*a)
        pp_, pc, pb, prof = pok.run_profile(*a)
        if not (nan_equal(pp_, packed) and nan_equal(pc, cost)
                and int(pb) == int(best)):
            raise AssertionError(f"poly_sampling {what}: the profiling "
                                 "instantiation differs")
        e = float(torch.max(torch.abs(packed - want_p).nan_to_num()))
        if has_nan:
            rel = 0.0 if torch.isnan(cost) and torch.isnan(want_c) else 1.0
        else:
            rel = abs(float(cost) - float(want_c)) / abs(float(want_c))
        line = (f"poly_sampling check, {what} (C={a[1].shape[0]}, N="
                f"{a[4].shape[0]}, path {a[5].shape[0]}, obstacles "
                f"{a[6].shape[0]} x {a[6].shape[1]}): winner {int(best)} "
                f"(plain {int(want_b)}), max|kernel-plain| rows {e:.3e}, "
                f"cost rel {rel:.3e}")
        ok = (int(best) == int(want_b) and torch.equal(
            torch.isnan(packed), torch.isnan(want_p)) and e <= POLY_ROW_TOL
            * (1 + float(torch.max(torch.abs(want_p).nan_to_num())))
            and rel <= 1e-12)
        if scene is not None:
            oracle = psp._eval_candidates(*scene)
            rows = packed.cpu().numpy()
            e_o = max(float(np.max(np.abs(rows[i] - oracle[k])))
                      for i, k in enumerate(pok.OUT_KEYS))
            line += (f"; oracle winner {oracle['best']}, max|kernel-oracle| "
                     f"{e_o:.3e}")
            ok = ok and oracle["best"] == int(best) and e_o <= \
                POLY_ORACLE_TOL * (1 + float(np.max(np.abs(rows))))
        print(line + "; profiling instantiation bit-equal")
        if not ok:
            raise AssertionError(f"poly_sampling {what}: kernel, plain and "
                                 "oracle differ")
        if has_nan and not (int(best) == int(want_b)
                            and torch.isnan(cost)):
            raise AssertionError(f"poly_sampling {what}: the first NaN "
                                 "did not win")
        err = max(err, e)
        if phases is None:
            phases = prof
    a = cases[0][1]
    C, N, n_path = a[1].shape[0], a[4].shape[0], a[5].shape[0]
    O, K = a[6].shape[:2]
    lib = pok._kernel()
    stream = torch.cuda.current_stream(dev).cuda_stream
    inv = pok._inverses(dev)
    bufs = poly_buffers(a, dev)

    def bare(s=stream):
        return poly_launch(lib, a, inv, bufs, s)

    ms, wrapper_ms = launcher_times(
        "poly_sampling", f"the JAX bench's scene (C={C}, N={N}, one "
        "launch)", bare, lambda: pok.run(*a), 200)
    graph = graph_ms(raising(bare))
    us = {k: v / (1 if k == "selection" else C) / mhz
          for k, v in phases.items()}
    print(f"phases poly_sampling the JAX bench's scene ({C} blocks, SM "
          f"{mhz:.0f} MHz): us a block (thread 0, barrier to barrier; the "
          "selection the last block's): "
          + ", ".join(f"{k} {v:.3f}" for k, v in us.items()))
    res = dict(err=err, ms=ms, wrapper_ms=wrapper_ms, graph_ms=graph,
               plain_ms=cuda_ms(lambda: pok.run_reference(*a), 10),
               bound=pok.bound_ms(C, N, n_path, O, K),
               chain=pok.chain_ms(C, N, O, K, cycles, mhz),
               serial_chain=pok.serial_chain_ms(C, N, cycles, mhz),
               phases_us=us,
               parent=poly_parent_check(pok, cases, dev, parent_csrc))
    print(f"poly_sampling: kernel {ms:.4f} ms (bare launcher; wrapper "
          f"{wrapper_ms:.4f}, from CUDA graphs {graph:.4f}), plain "
          f"{res['plain_ms']:.4f} ms, bound_ms {res['bound'][0]:.6f} "
          f"({res['bound'][1]}), chain_ms {res['chain']:.6f} (the "
          f"two launches' pricing {res['serial_chain']:.6f}); "
          f"max|kernel-plain| {err:.3e}")
    return res


def dp_poly_counts(dpe, ppk, reset=False):
    """The graph DP planner's kernel launch counters (set to 0 with
    ``reset``)."""
    if reset:
        dpe.dir_dist_launches = 0
        ppk.eval_launches = ppk.propagate_launches = 0
    return {"dir_dist_map": dpe.dir_dist_launches,
            "poly_eval_edges": ppk.eval_launches,
            "poly_propagate": ppk.propagate_launches}


def dp_poly_loop_phase(dpe, ppk, ticks):
    """SimStandalone on demo/country_follow with ``dp_poly_planner`` active
    (the demo planning set's block) and the scenario's other sets, the rule
    checker on, the launch counters set to 0 just before the loop and read
    just after.  Checks zero rule violations, no emergency plan, finite
    controls, per replan one field launch, four evaluation launches (two a
    level) and one propagation launch, and the end state against the JAX
    package's CPU loop's; prints the medians of ``runtime_environment`` and
    ``runtime_planning``.  Returns the first replan's grids and start state
    and the times."""
    import torch
    from tpl_tpu_torch.simulation import SimStandalone

    sim = SimStandalone(app_id="smoke_dp_poly",
                        scenario_path="demo/country_follow")
    store = sim.planning_app.sh_planners
    with store.lock():
        store.active_planner = DP_POLY
        prm = store.dp_poly_planner.params
        e, g = prm.dp_env, prm.dp_planner
        grid = ((e.t_steps, e.s_steps, e.l_steps, e.dir_steps),
                (g.eval_steps, g.t_steps, g.ds_steps, g.l_steps))
    if grid != DP_POLY_GRID:
        raise AssertionError(f"{DP_POLY} grid {grid} != {DP_POLY_GRID}")
    planner = sim.planning_app.planners[DP_POLY]
    controllers = sim.control_app.sh_controllers
    with sim.core.sh_state.lock():
        ss = sim.core.sh_state.sim
        ss.settings.running = True
        ss.settings.use_real_time = False
        ss.rule_checker.enable = True
    replans = []
    update = planner.dp_planner.update

    def counted_update(init_state, env):
        if not replans:
            replans.append(dict(
                init=np.array(init_state), occ=env.grid.occ_map.clone(),
                dd=env.grid.dir_dist_map.clone(),
                ref_line=env.grid.ref_line.clone(), ref_step=env.ref_step,
                env_params=env.params, params=planner.dp_planner.params))
        else:
            replans.append(None)
        return update(init_state, env)

    planner.dp_planner.update = counted_update
    tick_ms, env_ms, plan_ms = [], [], []
    dp_poly_counts(dpe, ppk, reset=True)
    for k in range(ticks):
        n = len(replans)
        t0 = time.perf_counter()
        sim.update()
        torch.cuda.synchronize()
        tick_ms.append((time.perf_counter() - t0) * 1e3)
        if len(replans) != n:
            env_ms.append(planner.runtime_environment)
            plan_ms.append(planner.runtime_planning)
        with store.lock():
            emergency = store.trajectory.emergency
        with controllers.lock():
            controls = np.array(controllers.controls)
        if emergency:
            raise AssertionError(f"{DP_POLY} tick {k}: emergency trajectory")
        if not np.all(np.isfinite(controls)):
            raise AssertionError(f"{DP_POLY} tick {k}: non-finite controls")
    counts = dp_poly_counts(dpe, ppk)
    n = len(replans)
    for row, per in DP_POLY_PER_REPLAN.items():
        if n == 0 or counts[row] != per * n:
            raise AssertionError(f"{DP_POLY}: {counts[row]} {row} launches "
                                 f"for {n} replans")
    with sim.core.sh_state.lock():
        s = sim.core.sh_state.sim
        violations = list(s.rule_checker.violations)
        t_end, x_end, v_end = s.t, s.ego.x, s.ego.v
    if violations:
        raise AssertionError(f"{DP_POLY}: rule violations {violations[:3]}")
    jt, jx, jv = DP_POLY_JAX_END
    print(f"{DP_POLY}: {ticks} ticks to t={t_end:.2f} s, ego x {x_end:.4f} "
          f"v {v_end:.4f} m/s (the JAX package's CPU loop: t={jt:.2f} s, x "
          f"{jx:.3f} v {jv:.3f}), 0 violations, no emergency, {n} replans; "
          "launches per replan: " + ", ".join(
              f"{r} {counts[r] / n:g}" for r in DP_POLY_PER_REPLAN))
    if not (abs(t_end - jt) < 1e-9 and abs(x_end - jx) <= DP_POLY_END_ATOL
            and abs(v_end - jv) <= DP_POLY_END_ATOL):
        raise AssertionError(f"{DP_POLY}: the loop ends at x {x_end}, v "
                             f"{v_end}, not at the JAX loop's x {jx}, v {jv}")
    print(f"{DP_POLY}: per-replan wall ms: runtime_environment median "
          f"{np.median(env_ms):.3f} (max {np.max(env_ms):.3f}), "
          f"runtime_planning median {np.median(plan_ms):.3f} (max "
          f"{np.max(plan_ms):.3f}, first {plan_ms[0]:.3f}: it builds and "
          f"uploads the first graph); per-tick total wall ms: median "
          f"{np.median(tick_ms):.3f}, max {np.max(tick_ms):.3f}")
    return dict(counts=counts, replans=n, first=replans[0], env_ms=env_ms,
                plan_ms=plan_ms, end=(t_end, x_end, v_end))


def dp_field_check(dpe, what, occ, ray, scal, step, R, mhz):
    """The field kernel against its plain version on the card (any
    differing cell raises) and its profiling instantiation against the
    kernel (a differing bit raises); prints the samples one march a slice
    and one march for all slices need, and the phases.  Returns (the
    kernel's field, the plain version's ms, us a block by phase)."""
    import torch

    got = dpe.dir_dist_map(occ, ray, *scal, step, R)
    prof, cycles, blocks = dpe.dir_dist_profile(occ, ray, *scal, step, R)
    want, plain_ms = plain_timed(
        lambda: dpe.dir_dist_reference(occ, ray, *scal, step, R))
    bad = int((got != want).sum())
    free = float((want == dpe.FREE_DIST).float().mean())
    per_slice = dpe.dir_dist_samples(want, step, R)
    merged = dpe.dir_dist_merged_samples(want, step, R)
    print(f"dir_dist_map check, {what} ({tuple(got.shape)}, ray_steps {R}): "
          f"{bad} cells differ; samples: {per_slice:,} one march a slice, "
          f"{merged:,} one march for all slices ({per_slice / merged:.2f} "
          f"x); {free:.3f} of the rays meet nothing")
    if bad:
        raise AssertionError(f"dir_dist_map {what}: {bad} cells differ")
    if not torch.equal(prof, got):
        raise AssertionError(f"dir_dist_map {what}: the profiling "
                             "instantiation's field differs")
    us = field_phase_line(what, cycles, blocks, mhz)
    return got, plain_ms, us


def field_phase_line(what, cycles, blocks, mhz):
    """One line of a profiled field: thread 0's us a block by phase."""
    us = {k: v / blocks / mhz for k, v in cycles.items()}
    print(f"phases dir_dist_map {what} ({blocks} blocks, SM {mhz:.0f} MHz): "
          f"us a block (thread 0, barrier to barrier): "
          + ", ".join(f"{k} {v:.3f}" for k, v in us.items()))
    return us


def eval_phase_line(ppk, what, prof, E, mhz):
    """One line of a profiled evaluation: an edge's thread's cycles by
    phase and the steps an edge took."""
    per = {k: prof[k] / E for k in ppk.EVAL_PHASES}
    print(f"phases poly_eval_edges {what} ({E:,} edges, SM {mhz:.0f} MHz): "
          "cycles an edge's thread: "
          + ", ".join(f"{k} {v:.1f}" for k, v in per.items())
          + f" (sum {sum(per.values()):.1f}); steps an edge: polynomial "
          f"{prof['poly_steps'] / E:.3f}, past te {prof['tail_steps'] / E:.3f}")
    return dict(per, poly_steps=prof["poly_steps"] / E,
                tail_steps=prof["tail_steps"] / E)


def dp_prop_check(ppk, what, bufs, plain_bufs):
    """The propagation kernel against its plain version on the card on
    equal inputs: every selection, propagated cost and the trajectory equal
    (NaN equal to NaN), else raises; the profiling instantiation bit-equal
    on fresh buffers.  Returns its {phase: cycles}."""
    import torch

    pts, node_cost, best, seg, node_off, seg_off, traj = bufs
    ppk.propagate_and_backtrack(*bufs)
    ppk.propagate_reference(*plain_bufs)
    inner = node_off[-2]
    b_bad = int((best[:inner] != plain_bufs[2][:inner]).sum())
    c_ok = nan_equal(node_cost[:inner], plain_bufs[1][:inner])
    t_ok = nan_equal(traj, plain_bufs[6])
    again = (pts, torch.zeros_like(node_cost), torch.zeros_like(best), seg,
             node_off, seg_off, torch.zeros_like(traj))
    prof = ppk.propagate_profile(*again)
    p_ok = (nan_equal(again[1], node_cost) and torch.equal(again[2], best)
            and nan_equal(again[6], traj))
    n_inf = int(torch.isinf(node_cost[1:inner]).sum())
    n_nan = int(torch.isnan(node_cost[:inner]).sum())
    print(f"poly_propagate check, {what} ({len(node_off) - 2} levels, "
          f"{node_off[-1]:,} nodes, {node_off[-1] - 1:,} edges): {b_bad} "
          f"selections differ, costs {'equal' if c_ok else 'DIFFER'}, "
          f"trajectory {'equal' if t_ok else 'DIFFERS'}; {n_inf} nodes "
          f"without an edge, {n_nan} NaN costs; profiling instantiation "
          f"{'bit-equal' if p_ok else 'DIFFERS'}")
    if b_bad or not c_ok or not t_ok:
        raise AssertionError(f"poly_propagate {what}: kernel and plain "
                             "version differ")
    if not p_ok:
        raise AssertionError(f"poly_propagate {what}: the profiling "
                             "instantiation differs")
    return prof


def prop_phase_line(ppk, what, prof, blocks, mhz):
    """One line of a profiled propagation: us a block of the last level and
    the arrival, the last block's lower levels and backtrack."""
    us = {k: v / (blocks if k in ("last_level", "arrival") else 1) / mhz
          for k, v in prof.items()}
    print(f"phases poly_propagate {what} ({blocks} blocks, SM {mhz:.0f} "
          "MHz): us (thread 0, barrier to barrier; a block for the last "
          "level and the arrival, the last block's for the lower levels "
          "and the backtrack): " + ", ".join(f"{k} {v:.3f}"
                                             for k, v in us.items()))
    return us


def prop_launch(ppk, lib, bufs, counter, stream, old=False):
    """The propagation through a library's bare launcher on ``bufs``
    (:func:`scenes.dp_poly_buffers`' layout): the tree's one launch or, with
    ``old``, a source's launch a level.  Returns the CUDA error code."""
    pts, node_cost, best, seg, node_off, seg_off, traj = bufs
    K = len(node_off) - 2
    offs = np.zeros(2 * ppk.MAX_LEVELS + 3, np.int32)
    offs[:K + 2] = node_off
    offs[ppk.MAX_LEVELS + 2:ppk.MAX_LEVELS + 3 + K] = seg_off
    head = (pts.data_ptr(), node_cost.data_ptr(), best.data_ptr(),
            seg.data_ptr(), traj.data_ptr(), offs.ctypes.data)
    if not old:
        return lib.poly_propagate(*head, counter.data_ptr(), K, stream)
    for k in range(K - 1, -1, -1):
        e = lib.poly_propagate(*head, K, k, stream)
        if e:
            return e
    return 0


def dp_standin_first(dpe, ppk, dev):
    """``--kernels-only``: a stand-in for the graph DP loop's first replan
    (no loop is driven): the test scene's ref line and params over seeded
    occupancy at the demo widths, the kernel's field of it, the demo
    graph's params."""
    import torch
    from tpl_tpu_torch import scenes

    env = scenes.dp_poly_env(True)
    occ = torch.from_numpy(scenes.dp_random_occ(8, density=0.05)).to(dev)
    env.adopt_grid(occ, env.grid.dist_map_lon)
    init = np.zeros(8)
    init[ppk.PP_DS], init[ppk.PP_L] = 8.0, 0.4
    return dict(what="seeded stand-in for the loop's first replan",
                init=init, occ=occ, dd=env.update_dir_dist_map(),
                ref_line=env.grid.ref_line, ref_step=env.ref_step,
                env_params=env.params, params=ppk.DpPolyParams())


def dp_parent_checks(dpe, ppk, field_cases, eval_cases, prop_cases, timed,
                     dev, mhz, parent_csrc):
    """With ``parent_csrc``: another version's field, evaluation (the
    launcher without the slice's scratch is recognised) and propagation (the
    launch a level is recognised) against the tree's on every field case
    ((what, occ, ray, scal, step, R)), every level of every evaluation case
    and every propagation case ((what, a function that makes fresh
    buffers)), every bit (a difference raises; NaN equal to NaN), times in
    turns (parent, tree, tree, parent) through the bare launchers by CUDA
    events for each field and evaluation case and from CUDA graphs for the
    ``timed`` cases ({"field": what, "eval": what, "prop": what}); a
    version that exports a profiling entry prints its "phases" lines.
    Returns {"field" / "eval" / "prop": {"events": ..., "graph": ...}} of
    the first parent, or {}."""
    import ctypes
    import torch
    from tpl_tpu_torch import _build

    stream = torch.cuda.current_stream(dev).cuda_stream
    lib_d, lib_p = dpe._kernel(), ppk._kernel()
    res = {}

    def field_of(a):
        what, occ, ray, scal, step, R = a
        return dpe.dir_dist_map(occ, ray, *scal, step, R)

    def field_call(a):
        what, occ, ray, scal, step, R = a
        T, S, L = occ.shape
        D = ray.shape[0]
        return lambda fn, out, s=None: fn(
            occ.data_ptr(), ray.data_ptr(), *scal, step, out.data_ptr(),
            T, S, L, D, R, stream if s is None else s)

    for i, csrc in enumerate(parents_with(parent_csrc, "dir_dist_map")):
        times = {}
        plib = compare_with_parent(
            "dir_dist_map", lib_d.dir_dist_map, csrc,
            [(a[0], field_of(a), field_call(a)) for a in field_cases],
            n=50, times=times)
        a = next(x for x in field_cases if x[0] == timed["field"])
        out = field_of(a)
        call = field_call(a)
        graph = in_turns_graph(
            raising(lambda s: call(plib.dir_dist_map, out, s)),
            raising(lambda s: call(lib_d.dir_dist_map, out, s)))
        print(f"dir_dist_map {a[0]} vs the source in {csrc}, from CUDA "
              "graphs: ms per launch parent {:.4f}, new {:.4f}, new {:.4f}, "
              "parent {:.4f}".format(*graph))
        if i == 0:
            res["field"] = {"events": times[a[0]], "graph": graph}
        if hasattr(plib, "dir_dist_map_profile"):
            fn = plib.dir_dist_map_profile
            fn.restype = ctypes.c_int
            fn.argtypes = lib_d.dir_dist_map_profile.argtypes
            n_ph = len(dpe.PHASES)
            for a in field_cases:
                what, occ, ray, scal, step, R = a
                T, S, L = occ.shape
                out = torch.empty_like(field_of(a))
                cyc = torch.zeros(n_ph, dtype=torch.int64, device=dev)
                if fn(occ.data_ptr(), ray.data_ptr(), *scal, step,
                      out.data_ptr(), cyc.data_ptr(), T, S, L,
                      ray.shape[0], R, stream):
                    raise RuntimeError("the parent's profiling launch failed")
                if not torch.equal(out, field_of(a)):
                    raise AssertionError(f"dir_dist_map {what}: the "
                                         f"profiling instantiation in {csrc} "
                                         "differs")
                blocks = int(np.prod(plib_grid_blocks(plib, T, S)))
                field_phase_line(f"{what}, the source in {csrc}",
                                 dict(zip(dpe.PHASES, cyc.cpu().tolist())),
                                 blocks, mhz)

    for i, csrc in enumerate(parents_with(parent_csrc, "poly_planner")):
        with open(os.path.join(csrc, "poly_planner.cu")) as f:
            old = "float* slice" not in f.read()
        times = {}
        cases = []
        for c in eval_cases:
            for k in range(len(c["starts"])):
                sl = torch.empty(c["dd"][..., 0].numel(), device=dev)
                cases.append((
                    f"{c['what']}, start index {c['key']}, level {k + 1}",
                    c["level"][k + 1],
                    lambda fn, out, c=c, k=k, sl=sl: eval_fn_call(
                        ppk, fn, c, k, out, sl, stream, False),
                    lambda fn, out, c=c, k=k, sl=sl: eval_fn_call(
                        ppk, fn, c, k, out, sl, stream, old)))
        argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                    + [ctypes.c_void_p]) if old else None
        plib = compare_with_parent("poly_planner", lib_p.poly_eval_edges,
                                   csrc, cases, n=30, times=times,
                                   argtypes=argtypes)
        c = next(x for x in eval_cases if x["what"] == timed["eval"][0]
                 and x["key"] == timed["eval"][1])
        outs = [torch.empty_like(x) for x in c["level"][1:]]
        sl = torch.empty(c["dd"][..., 0].numel(), device=dev)

        def both(fn, is_old):
            def run(s):
                for k in range(len(outs)):
                    err = eval_fn_call(ppk, fn, c, k, outs[k], sl, s, is_old)
                    if err:
                        return err
                return 0
            return raising(run)

        graph = in_turns_graph(both(plib.poly_eval_edges, old),
                               both(lib_p.poly_eval_edges, False))
        print(f"poly_eval_edges {c['what']}, start index {c['key']}, both "
              f"levels vs the source in {csrc}, from CUDA graphs: ms parent "
              "{:.4f}, new {:.4f}, new {:.4f}, parent {:.4f}".format(*graph))
        if i == 0:
            keys = [w for w, *_ in cases if w.startswith(
                f"{c['what']}, start index {c['key']},")]
            res["eval"] = {"events": tuple(sum(times[w][j] for w in keys)
                                           for j in range(4)),
                           "graph": graph}
        if hasattr(plib, "poly_eval_edges_profile"):
            fn = plib.poly_eval_edges_profile
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p] * (8 if old else 9)
                           + [ctypes.c_int] * 8 + [ctypes.c_void_p])
            n_prof = len(ppk.EVAL_PHASES) + len(ppk.EVAL_COUNTS)
            for c in eval_cases:
                for k in range(len(c["starts"])):
                    out = torch.empty_like(c["level"][k + 1])
                    prof = torch.zeros(n_prof, dtype=torch.int64, device=dev)
                    if eval_fn_call(ppk, fn, c, k, out, sl, stream, old,
                                    prof):
                        raise RuntimeError("the parent's profiling launch "
                                           "failed")
                    if not torch.equal(out, c["level"][k + 1]):
                        raise AssertionError("poly_eval_edges: the profiling "
                                             f"instantiation in {csrc} "
                                             "differs")
                    eval_phase_line(
                        ppk, f"{c['what']}, start index {c['key']}, level "
                        f"{k + 1}, the source in {csrc}", dict(zip(
                            ppk.EVAL_PHASES + ppk.EVAL_COUNTS,
                            prof.cpu().tolist())), len(c["starts"][k]), mhz)
        prop = prop_parent_check(ppk, plib, csrc, prop_cases, timed["prop"],
                                 dev)
        if i == 0:
            res["prop"] = prop
    return res


def prop_parent_check(ppk, plib, csrc, prop_cases, timed, dev):
    """The propagation of the library ``plib`` (built from ``csrc``; a
    source of the launch a level is recognised) against the tree's on every
    case, every selection, propagated cost and the trajectory bit for bit
    (a difference raises), and times in turns on the ``timed`` case by CUDA
    events and from CUDA graphs.  Returns {"events": ..., "graph": ...}."""
    import ctypes
    import torch

    with open(os.path.join(csrc, "poly_planner.cu")) as f:
        old = "int* counter" not in f.read()
    plib.poly_propagate.restype = ctypes.c_int
    plib.poly_propagate.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        if old else ppk._kernel().poly_propagate.argtypes)
    lib = ppk._kernel()
    stream = torch.cuda.current_stream(dev).cuda_stream
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    res = None
    for what, make in prop_cases:
        a, b = make(), make()
        for lb, bufs, is_old in ((plib, a, old), (lib, b, False)):
            if prop_launch(ppk, lb, bufs, counter, stream, is_old):
                raise RuntimeError("poly_propagate launch failed")
        torch.cuda.synchronize()
        same = (nan_equal(a[1], b[1]) and torch.equal(a[2], b[2])
                and nan_equal(a[6], b[6]))
        print(f"poly_propagate {what} vs the source in {csrc}: selections, "
              f"costs and trajectory {'bit-equal' if same else 'DIFFER'}")
        if not same:
            raise AssertionError(f"poly_propagate {what}: the result differs "
                                 "from the parent kernel's")
        if what == timed:
            def run(lb, bufs, is_old):
                return raising(lambda s=stream: prop_launch(
                    ppk, lb, bufs, counter, s, is_old))

            p_run, n_run = run(plib, a, old), run(lib, b, False)
            (ea, ed), (eb, ec) = in_turns(lambda: p_run(stream),
                                          lambda: n_run(stream), 50)
            graph = in_turns_graph(p_run, n_run)
            print(f"poly_propagate {what} vs the source in {csrc}: ms "
                  f"parent {ea:.4f}, new {eb:.4f}, new {ec:.4f}, parent "
                  f"{ed:.4f}; from CUDA graphs parent {graph[0]:.4f}, new "
                  f"{graph[1]:.4f}, new {graph[2]:.4f}, parent "
                  f"{graph[3]:.4f}")
            res = {"events": (ea, eb, ec, ed), "graph": graph}
    return res


def plib_grid_blocks(plib, T, S):
    """The blocks of a field launch: S x ceil(T / 32) for a source with the
    one march for all slices (it exports ``dir_dist_map_prepare``), else
    the earlier grid of ceil(S / 4) x T."""
    if hasattr(plib, "dir_dist_map_prepare"):
        return S, -(-T // 32)
    return -(-S // 4), T


def eval_fn_call(ppk, fn, c, k, out, field_slice, stream, old, prof=None):
    """Level k of evaluation case ``c`` through the launcher ``fn`` (a
    profiling entry when ``prof`` is given); ``old``: a launcher without
    the slice's scratch.  Returns the CUDA error code."""
    T, S, L, D = c["dd"].shape
    ptrs = [c["level"][k].data_ptr(), c["starts"][k].data_ptr(),
            c["specs"][k].data_ptr(), c["dd"].data_ptr(), c["rl"].data_ptr()]
    if not old:
        ptrs.append(field_slice.data_ptr())
    ptrs.append(out.data_ptr())
    if prof is not None:
        ptrs.append(prof.data_ptr())
    K = len(c["starts"])
    return fn(*ptrs, c["consts"].ctypes.data, len(c["starts"][k]),
              int(k == K - 1), c["n_int"], T, S, L, D, c["rl"].shape[0],
              stream)


def raising(launch):
    """``launch(stream)`` (returns a CUDA error code) as a function that
    raises on an error."""
    def run(stream):
        err = launch(stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
    return run


def in_turns_graph(old, new):
    """Device ms per launch of ``old(stream)`` and ``new(stream)`` from CUDA
    graphs (``graph_ms``), in turns: (old, new, new, old)."""
    return (graph_ms(old), graph_ms(new), graph_ms(new), graph_ms(old))


def dp_poly_kernel_phase(dpe, ppk, first, dev, cycles, mhz,
                         parent_csrc=None):
    """The graph DP planner's three kernels against their plain versions on
    the card at the demo widths: the field on tests/test_dp_poly_planner.py's
    scene (``scenes.dp_poly_env``), seeded random occupancy (also at
    ray_steps 40) and the loop's first-replan grid, cell for cell, its
    profiling instantiation bit-equal with a "phases" line for each; the
    edge evaluation at four start indices (two of them capped at 400,000
    edges) on both levels, from the loop's first start state over the
    scene's field and over the loop's first field (t, ds, l exact, s and
    the cost to DP_EVAL_RTOL), its profiling instantiation bit-equal with a
    "phases" line for each level; the propagation on the kernel's own end
    points of each and on seeded graphs with equal least costs, NaN costs
    and nodes without edges, every selection equal.  Times each kernel
    through its bare launcher and its wrapper in turns, the field and the
    evaluation also as device time from CUDA graphs, the plain versions,
    ``bound_ms`` (the needed work and, beside it, one march a slice / every
    step of every edge) and ``chain_ms``; with ``parent_csrc``
    (:func:`dp_parent_checks`) holds another version's field and evaluation
    to the tree's, every bit.  ``first`` is the loop's first replan (or a
    stand-in, :func:`dp_standin_first`), whose own field is also held to
    the kernel's."""
    import torch
    from tpl_tpu_torch import scenes

    f32 = np.float32
    env = scenes.dp_poly_env(True)
    p = env.params
    ray, step = dpe.ray_table(p.dir_min, p.dir_max, p.dir_steps,
                              p.s_step_size, p.l_step_size)
    ray = ray.to(dev)
    scal = [float(f32(x)) for x in (p.s_min, p.s_step_size, p.l_min,
                                    p.l_step_size)]
    R = env.ray_steps_default()
    first_what = first.get("what", "the loop's first replan")
    fields, field_us = {}, {}
    field_cases = []
    for what, occ, r in (
            ("the test scene", env.grid.occ_map, R),
            ("seeded random occupancy", torch.from_numpy(
                scenes.dp_random_occ(5)).to(dev), R),
            ("seeded random occupancy, ray_steps 40", torch.from_numpy(
                scenes.dp_random_occ(6, density=0.3)).to(dev), 40),
            (first_what, first["occ"], R)):
        dd, field_plain_ms, field_us[what] = dp_field_check(
            dpe, what, occ, ray, scal, step, r, mhz)
        fields[what] = dd
        field_cases.append((what, occ, ray, scal, step, r))
    if not torch.equal(fields[first_what], first["dd"]):
        raise AssertionError("dir_dist_map: the loop's field differs")
    field = fields["the test scene"]
    cpu = dpe.dir_dist_reference(env.grid.occ_map.cpu(), ray.cpu(), *scal,
                                 step, R)
    if not torch.equal(field.cpu(), cpu):
        raise AssertionError("dir_dist_map: the card's field differs from "
                             "the plain version's on the CPU")

    kp = first["params"]
    n_int = kp.n_int_steps()
    m4, h5 = ppk.inverses_f32()
    err = dict(s=0.0, cost=0.0)
    cases, eval_us = [], {}
    prop_cases, prop_prof = [], {}
    for key in scenes.dp_poly_keys():
        for what, dd, rl, ref_step, ep in (
                ("the test scene", field, env.grid.ref_line, env.ref_step,
                 p),
                (first_what, first["dd"], first["ref_line"],
                 first["ref_step"], first["env_params"])):
            node_steps, edge_steps = ppk.build_eval_graph(kp, *key)
            ev = ppk.eval_params(kp, ep, f32(ref_step))
            init = np.array(first["init"], np.float32)
            init[ppk.PP_DS] = kp.ds_min + key[0] * kp.ds_step_size + 0.3
            init[ppk.PP_L] = kp.l_min + key[1] * kp.l_step_size - 0.1
            level = [torch.from_numpy(init[None]).to(dev)]
            starts, specs = [], []
            for k in range(len(edge_steps)):
                starts.append(torch.from_numpy(edge_steps[k]).to(dev))
                specs.append(torch.from_numpy(node_steps[k + 1].astype(
                    np.float32)).to(dev))
                last = k == len(edge_steps) - 1
                got = ppk.eval_edges(level[k], starts[k], specs[k], last, ev,
                                     dd, rl, n_int)
                want = ppk.eval_edges_reference(level[k], starts[k],
                                                specs[k], last, ev, dd, rl,
                                                n_int)
                prof_out, prof = ppk.eval_edges_profile(
                    level[k], starts[k], specs[k], last, ev, dd, rl, n_int)
                if not torch.equal(prof_out, got):
                    raise AssertionError(f"poly_eval_edges {key} level "
                                         f"{k + 1}: the profiling "
                                         "instantiation's end points differ")
                exact = [ppk.PP_T, ppk.PP_DS, ppk.PP_DDS, ppk.PP_L,
                         ppk.PP_DL, ppk.PP_DDL]
                line = []
                for c, name in ((ppk.PP_S, "s"), (ppk.PP_COST, "cost")):
                    d = torch.abs(got[:, c] - want[:, c])
                    rel = float(torch.max(d / torch.clamp(
                        torch.abs(want[:, c]), min=1e-30)))
                    err[name] = max(err[name], float(d.max()))
                    line.append(f"{name} max abs {float(d.max()):.3e} rel "
                                f"{rel:.3e}")
                    if rel > DP_EVAL_RTOL:
                        raise AssertionError(f"poly_eval_edges {key} level "
                                             f"{k + 1}: {name} rel {rel}")
                if not torch.equal(got[:, exact], want[:, exact]):
                    raise AssertionError(f"poly_eval_edges {key} level "
                                         f"{k + 1}: t, ds or l differ")
                print(f"poly_eval_edges check, {what}, start index {key}, "
                      f"level {k + 1} ({len(edge_steps[k]):,} edges): "
                      + ", ".join(line) + "; t, ds, l exact")
                needed = ppk.eval_steps_needed(level[k], starts[k], specs[k],
                                               last, ev, n_int)
                if (prof["poly_steps"], prof["tail_steps"]) != needed:
                    raise AssertionError(f"poly_eval_edges {key} level "
                                         f"{k + 1}: the kernel took "
                                         f"{prof['poly_steps']} + "
                                         f"{prof['tail_steps']} steps, the "
                                         f"edges need {needed}")
                eval_us[(what, key, k)] = eval_phase_line(
                    ppk, f"{what}, start index {key}, level {k + 1}", prof,
                    len(edge_steps[k]), mhz)
                level.append(got)
            node_off, seg, seg_off = ppk.graph_layout(
                [len(x) for x in level], edge_steps)
            seg = torch.from_numpy(seg).to(dev)

            def bufs(lv, node_off=node_off, seg=seg, seg_off=seg_off,
                     K=len(edge_steps)):
                N = node_off[-1]
                return (torch.cat(lv).contiguous(),
                        torch.zeros(N, dtype=torch.float64, device=dev),
                        torch.zeros(N, dtype=torch.int32, device=dev), seg,
                        node_off, seg_off,
                        torch.zeros((K + 1, 8), dtype=torch.float64,
                                    device=dev))
            b = bufs(level)
            prop_prof[(what, key)] = dp_prop_check(
                ppk, f"{what}, start index {key}", b, bufs(level))
            prop_cases.append((f"{what}, start index {key}",
                               lambda lv=level, bufs=bufs: bufs(lv)))
            cases.append(dict(
                key=key, what=what, level=level, bufs=b,
                edge_steps=edge_steps, ev=ev, dd=dd, rl=rl, starts=starts,
                specs=specs, n_int=n_int, consts=np.concatenate(
                    [ev, m4.ravel(), h5.ravel()]).astype(np.float32)))
    for seed, ties, nan, levels in ((0, True, True, 2), (1, True, False, 2),
                                    (2, False, True, 2), (3, True, True, 1),
                                    (4, True, True, 3), (5, False, False, 3)):
        node_pts, edge_steps = scenes.dp_poly_propagation_case(
            seed, n1=2000, e2=400_000 if levels < 3 else 20_000,
            e3=400_000, ties=ties, nan=nan, levels=levels)
        what = f"seeded (ties {ties}, NaN {nan}, {levels} levels)"
        dp_prop_check(ppk, what,
                      scenes.dp_poly_buffers(node_pts, edge_steps, dev),
                      scenes.dp_poly_buffers(node_pts, edge_steps, dev))
        prop_cases.append((what, lambda n=node_pts, e=edge_steps:
                           scenes.dp_poly_buffers(n, e, dev)))

    # times: the field on the loop's first grid, the evaluation of both
    # levels and the propagation at the loop's capped start index (7, 10)
    lib_d, lib_p = dpe._kernel(), ppk._kernel()
    stream = torch.cuda.current_stream(dev).cuda_stream
    occ = first["occ"]
    T, S, L = occ.shape
    D = ray.shape[0]
    out = torch.empty((T, S, L, D), dtype=torch.float32, device=dev)

    def field_bare(s=stream):
        return lib_d.dir_dist_map(occ.data_ptr(), ray.data_ptr(), *scal,
                                  step, out.data_ptr(), T, S, L, D, R, s)

    field_ms, field_wrapper_ms = launcher_times(
        "dir_dist_map", f"{first_what} ({T} x {S} x {L} x {D}, "
        f"ray_steps {R})", field_bare,
        lambda: dpe.dir_dist_map(occ, ray, *scal, step, R), 50)
    field_graph_ms = graph_ms(raising(field_bare))
    _, field_plain_ms = plain_timed(
        lambda: dpe.dir_dist_reference(occ, ray, *scal, step, R))
    field_bound = dpe.dir_dist_needed_bound_ms(first["dd"], step, R)
    field_slice_bound = dpe.dir_dist_bound_ms(first["dd"], step, R)
    field_chain = dpe.dir_dist_chain_ms(first["dd"], step, R, cycles, mhz)

    c = next(x for x in cases if x["key"] == (7, 10)
             and x["what"] == first_what)
    pts, node_cost, best, seg, node_off, seg_off, traj = c["bufs"]
    dd, rl, ev = c["dd"], c["rl"], c["ev"]
    K = len(c["edge_steps"])
    starts, specs = c["starts"], c["specs"]
    outs = [torch.empty_like(c["level"][k + 1]) for k in range(K)]
    field_slice = torch.empty(T * S * L, dtype=torch.float32, device=dev)

    def eval_bare(s=stream):
        for k in range(K):
            e = eval_fn_call(ppk, lib_p.poly_eval_edges, c, k, outs[k],
                             field_slice, s, False)
            if e:
                return e
        return 0

    def eval_wrapper():
        for k in range(K):
            ppk.eval_edges(c["level"][k], starts[k], specs[k], k == K - 1,
                           ev, dd, rl, n_int, out=outs[k])

    E = [len(e) for e in c["edge_steps"]]
    eval_ms, eval_wrapper_ms = launcher_times(
        "poly_eval_edges", f"start index (7, 10), both levels ({E[0]:,} + "
        f"{E[1]:,} edges, {ppk.EVAL_KERNELS * K} launches)", eval_bare,
        eval_wrapper, 50)
    eval_graph_ms = graph_ms(raising(eval_bare))
    _, eval_plain_ms = plain_timed(lambda: [ppk.eval_edges_reference(
        c["level"][k], starts[k], specs[k], k == K - 1, ev, dd, rl, n_int)
        for k in range(K)])
    n_starts = [len(c["level"][k]) for k in range(K)]
    steps = [ppk.eval_steps_needed(c["level"][k], starts[k], specs[k],
                                   k == K - 1, ev, n_int) for k in range(K)]
    eval_bound = ppk.eval_needed_bound_ms(
        n_starts, E, dd.shape, rl.shape[0], sum(x[0] for x in steps),
        sum(x[1] for x in steps))
    eval_full_bound = ppk.eval_bound_ms(n_starts, E, dd.shape, rl.shape[0],
                                        n_int)
    eval_chain = K * ppk.eval_chain_ms(n_int, cycles, mhz)

    counter = torch.zeros(1, dtype=torch.int32, device=dev)

    def prop_bare(s=stream):
        return prop_launch(ppk, lib_p, c["bufs"], counter, s)

    prop_ms, prop_wrapper_ms = launcher_times(
        "poly_propagate", f"start index (7, 10) ({node_off[-1]:,} nodes, "
        "one launch)", prop_bare,
        lambda: ppk.propagate_and_backtrack(pts, node_cost, best, seg,
                                            node_off, seg_off, traj), 50)
    prop_graph_ms = graph_ms(raising(prop_bare))
    n_last = node_off[K] - node_off[K - 1]
    prop_us = prop_phase_line(ppk, f"{first_what}, start index (7, 10)",
                              prop_prof[(first_what, (7, 10))],
                              -(-n_last // 8), mhz)
    plain_bufs = (pts, node_cost.clone(), best.clone(), seg, node_off,
                  seg_off, traj.clone())
    _, prop_plain_ms = plain_timed(
        lambda: ppk.propagate_reference(*plain_bufs))
    prop_bound = ppk.propagate_bound_ms(node_off, seg_off)
    prop_chain = ppk.propagate_chain_ms(node_off, seg.cpu().numpy(),
                                        seg_off, cycles, mhz)
    prop_serial_chain = ppk.propagate_chain_ms(
        node_off, seg.cpu().numpy(), seg_off, cycles, mhz, one_launch=False)
    parent = dp_parent_checks(
        dpe, ppk, field_cases, cases, prop_cases,
        {"field": first_what, "eval": (first_what, (7, 10)),
         "prop": f"{first_what}, start index (7, 10)"}, dev, mhz,
        parent_csrc)
    res = {
        "dir_dist_map": dict(
            err=0.0, ms=field_ms, wrapper_ms=field_wrapper_ms,
            graph_ms=field_graph_ms, plain_ms=field_plain_ms,
            bound=field_bound, per_slice_bound=field_slice_bound,
            chain=field_chain, phases_us=field_us[first_what],
            parent=parent.get("field")),
        "poly_eval_edges": dict(
            err=max(err.values()), ms=eval_ms, wrapper_ms=eval_wrapper_ms,
            graph_ms=eval_graph_ms, plain_ms=eval_plain_ms,
            bound=eval_bound, full_scan_bound=eval_full_bound,
            chain=eval_chain, steps_needed=steps,
            phases=[eval_us[(first_what, (7, 10), k)] for k in range(K)],
            parent=parent.get("eval")),
        "poly_propagate": dict(err=0.0, ms=prop_ms,
                               wrapper_ms=prop_wrapper_ms,
                               graph_ms=prop_graph_ms,
                               plain_ms=prop_plain_ms, bound=prop_bound,
                               chain=prop_chain,
                               serial_chain=prop_serial_chain,
                               phases_us=prop_us,
                               parent=parent.get("prop"))}
    for name, r in res.items():
        extra = (f", from CUDA graphs {r['graph_ms']:.4f}"
                 if "graph_ms" in r else "")
        print(f"{name}: kernel {r['ms']:.4f} ms (bare launcher; wrapper "
              f"{r['wrapper_ms']:.4f}{extra}), plain {r['plain_ms']:.4f} ms, "
              f"bound_ms {r['bound'][0]:.6f} ({r['bound'][1]}), chain_ms "
              f"{r['chain']:.6f}; max|kernel-plain| {r['err']:.3e}")
    print(f"dir_dist_map: bound_ms of one march a slice "
          f"{field_slice_bound[0]:.6f} ({field_slice_bound[1]}); "
          f"poly_eval_edges: bound_ms of every step of every edge "
          f"{eval_full_bound[0]:.6f} ({eval_full_bound[1]}), steps needed "
          f"(polynomial, past te) a level {steps}")
    return res


def controller_loop_phase(itt, itm, rstp, rmp, name, ticks):
    """SimStandalone on demo/country_follow with the scenario's own sets
    (the RSTP planner, fused, H=250) and ``name`` active, one of the
    controllers beside the spatial MPC, the rule checker on, the launch
    counters of every kernel on the path set to 0 just before the loop and
    read just after.  Checks finite controls, the ego moving, the rule
    violations and the end state against the JAX package's CPU loop's
    (``CONTROLLER_JAX_END``), 2 ``ilqr_rstp`` and 1 ``rstp_rampify`` launches
    per replan, none of the spatial MPC's, and for the time MPC exactly one
    launch of its kernel per solve (the host controllers launch none);
    prints the per-tick control wall of the ticks the controller drove (the
    collision screen's hard brake drives the others).  For the time MPC,
    keeps the solves of ``RECORD_TIME_SOLVES``."""
    import torch
    from tpl_tpu_torch.simulation import SimStandalone

    sim = SimStandalone(app_id=f"smoke_{name}",
                        scenario_path="demo/country_follow")
    store = sim.planning_app.sh_planners
    controllers = sim.control_app.sh_controllers
    with store.lock():
        active = store.active_planner
        params = store.path_vel_decomp_planner.params
        cfg = (params.use_fused, params.horizon, params.collision_screen)
    if active != "path_vel_decomp_planner" or cfg != (True, RSTP_H, True):
        raise AssertionError(f"planning set: {active} {cfg}")
    with controllers.lock():
        controllers.active_controller = name
        mp = controllers.model_predictive_controller_time.params
        mpc_cfg = (mp.horizon, mp.step, mp.max_iterations)
    if name == TIME_MPC and mpc_cfg != (MPC_TIME_T, 0.05, 20):
        raise AssertionError(f"control set: {name} {mpc_cfg}")
    ctrl = sim.control_app.controllers[name]
    planner = sim.planning_app.planners["path_vel_decomp_planner"]
    with sim.core.sh_state.lock():
        ss = sim.core.sh_state.sim
        ss.settings.running = True
        ss.settings.use_real_time = False
        ss.rule_checker.enable = True

    # the loop's own time-MPC solves, recorded as the controller makes them
    solve = itt.update
    rec = {"n": 0, "picked": [], "events": []}

    def recording(buf, *args):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = solve(buf, *args)
        ev[1].record()
        rec["events"].append(ev)
        if rec["n"] in RECORD_TIME_SOLVES:
            rec["picked"].append((f"loop solve {rec['n']}", buf.clone(),
                                  args))
        rec["n"] += 1
        return out

    itt.update = recording
    try:
        tick_ms, driven_ms, its, emergency = [], [], [], 0
        solves0 = ctrl.opt.updates if name == TIME_MPC else 0
        itt.launches = itm.launches = rstp.launches = rmp.launches = 0
        for k in range(ticks):
            t0 = time.perf_counter()
            sim.update()
            torch.cuda.synchronize()
            tick_ms.append((time.perf_counter() - t0) * 1e3)
            with store.lock():
                latched = store.trajectory.emergency
            with controllers.lock():
                control_ms = controllers.runtime * 1e3
                controls = np.array(controllers.controls)
            if latched:
                emergency += 1
            else:
                driven_ms.append(control_ms)
            if name == TIME_MPC and ctrl.opt.updates - solves0 > len(its):
                its.append(ctrl.opt.iterations)
            if not np.all(np.isfinite(controls)):
                raise AssertionError(f"{name} tick {k}: non-finite controls")
        launches = dict(ilqr_tracking_mpc_time=itt.launches,
                        ilqr_tracking_mpc=itm.launches,
                        ilqr_rstp=rstp.launches, rstp_rampify=rmp.launches)
        solves = ctrl.opt.updates - solves0 if name == TIME_MPC else 0
    finally:
        itt.update = solve

    replans = planner.fused.steps
    with sim.core.sh_state.lock():
        s = sim.core.sh_state.sim
        n_viol = len(s.rule_checker.violations)
        end = (s.t, s.ego.x, s.ego.y, s.ego.v)
    jax_end = CONTROLLER_JAX_END[name]
    print(f"{name}: {ticks} ticks to t={end[0]:.2f} s, ego x {end[1]:.4f} y "
          f"{end[2]:.4f} v {end[3]:.4f} m/s, {n_viol} violations (the JAX "
          f"package's CPU loop: t={jax_end[0]:.2f} s, x {jax_end[1]:.4f} y "
          f"{jax_end[2]:.4f} v {jax_end[3]:.4f}, {jax_end[4]} violations); "
          f"{emergency} ticks of the screen's hard brake, {replans} replans, "
          f"{solves} time-MPC solves; launches: {launches}")
    if n_viol != jax_end[4]:
        raise AssertionError(f"{name}: {n_viol} rule violations, the JAX "
                             f"loop {jax_end[4]}")
    if not (abs(end[0] - jax_end[0]) < 1e-9 and max(
            abs(a - b) for a, b in zip(end[1:], jax_end[1:4]))
            <= CONTROLLER_END_ATOL):
        raise AssertionError(f"{name}: the loop ends at {end}, not at the "
                             f"JAX loop's {jax_end}")
    if not end[3] > 1.0:
        raise AssertionError(f"{name}: ego speed {end[3]} at the end")
    if replans < ticks - 5 or (launches["ilqr_rstp"], launches[
            "rstp_rampify"]) != (2 * replans, replans):
        raise AssertionError(f"{name}: {launches} for {replans} replans")
    if launches["ilqr_tracking_mpc"]:
        raise AssertionError(f"{name}: the spatial MPC launched")
    if name == TIME_MPC:
        if solves < ticks - emergency - 5 \
                or launches["ilqr_tracking_mpc_time"] != solves:
            raise AssertionError(f"{name}: {launches} for {solves} solves")
        solve_ms = [a.elapsed_time(b) for a, b in rec["events"]]
        print(f"{name}: solve on the card (CUDA events) ms: median "
              f"{np.median(solve_ms):.4f}, max {np.max(solve_ms):.4f} (the "
              f"first, the kernel's first launch here, {solve_ms[0]:.4f}; "
              f"the rest at most {np.max(solve_ms[1:]):.4f}); iterations "
              f"per solve: median {np.median(its):.1f}, max {np.max(its)}")
    elif launches["ilqr_tracking_mpc_time"]:
        raise AssertionError(f"{name}: the time-MPC kernel launched")
    print(f"{name}: per-tick control wall ms over the {len(driven_ms)} ticks "
          f"it drove: median {np.median(driven_ms):.3f}, max "
          f"{np.max(driven_ms):.3f}; per-tick total wall ms: median "
          f"{np.median(tick_ms):.3f}, max {np.max(tick_ms):.3f}")
    solve_ms = [a.elapsed_time(b) for a, b in rec["events"]]
    return dict(launches=launches, picked=rec["picked"],
                control_ms=driven_ms, ticks=ticks,
                solve_ms=dict(first=solve_ms[0], median=np.median(solve_ms),
                              max=max(solve_ms)) if solve_ms else None)


def compare_time_solves(itt, got, want, H, what):
    """Time-MPC kernel against plain results: raises beyond MPC_TIME_TOL
    (atol + rtol) or on another mu_step or iteration count; returns (max
    |x|, |u| difference, the unpacked kernel result)."""
    a = itt.unpack_outputs(got.cpu().numpy(), H)
    b = itt.unpack_outputs(want.cpu().numpy(), H)
    d = {k: float(np.max(np.abs(a[k] - b[k]))) for k in ("x", "u", "lam")}
    over = max(float(np.max(np.abs(a[k] - b[k]) - MPC_TIME_TOL
                            * (1.0 + np.abs(b[k])))) for k in d)
    dcost = abs(a["traj_costs"] - b["traj_costs"]) / max(
        abs(b["traj_costs"]), 1e-300)
    print(f"ilqr_tracking_mpc_time check {what}: max|dx| {d['x']:.3e}, "
          f"max|du| {d['u']:.3e}, max|dlam| {d['lam']:.3e}, cost rel "
          f"{dcost:.3e}, mu_step {a['mu_step']}/{b['mu_step']}, iterations "
          f"{a['iterations']}/{b['iterations']}")
    if over > 0.0 or not dcost <= MPC_TIME_TOL:
        raise AssertionError(f"{what}: kernel and plain solves differ")
    if (a["mu_step"], a["iterations"]) != (b["mu_step"], b["iterations"]):
        raise AssertionError(f"{what}: mu_step / iterations differ")
    if not np.all(np.isfinite(a["x"])):
        raise AssertionError(f"{what}: non-finite solve")
    return max(d["x"], d["u"]), a


def mpc_time_phase(itt, scenes, picked, dev, cycles, mhz, parent_csrc=None):
    """The time-indexed MPC kernel against the plain ``make_update_fn`` on
    the card, float64: on the seeded cases of ``scenes.mpc_time_case`` (a
    straight reference at UTM magnitude, a curved one, a warm-started
    two-round solve, a reference that ends inside the horizon) and on the
    warm-started solves recorded in the time MPC's loop; the profiling
    instantiation and (with ``parent_csrc``) another version of the source
    on every case (``mpc_time_kernel_checks``); times through the bare
    launcher and the wrapper in turns and the plain version, with
    ``bound_ms`` and ``chain_ms`` at the timed solves' iteration counts.
    Without ``picked`` (``--kernels-only``) the seeded cases alone, checked
    and profiled, and no times."""
    import torch

    cases = []
    for kind in scenes.MPC_TIME_KINDS:
        host, args = scenes.mpc_time_case(kind)
        cases.append((kind, torch.from_numpy(host).to(dev), args))
    if not picked:
        mpc_time_kernel_checks(itt, cases, dev, mhz, parent_csrc,
                               [w for w, _, _ in cases])
        return None
    if len(picked) != len(RECORD_TIME_SOLVES):
        raise AssertionError(f"recorded {len(picked)} time-MPC loop solves")
    cases += picked
    max_err, iterations = 0.0, {}
    for what, buf, args in cases:
        if args[:3] != (MPC_TIME_H, 128, MPC_TIME_T):
            raise AssertionError(f"{what}: shapes {args[:3]}")
        got = itt.update(buf, *args)
        want = itt.update_reference(buf, *args)
        torch.cuda.synchronize()
        err, res = compare_time_solves(itt, got, want, MPC_TIME_H, what)
        max_err = max(max_err, err)
        iterations[what] = res["iterations"]

    loop_case = cases[len(scenes.MPC_TIME_KINDS)]
    phases, parent = mpc_time_kernel_checks(itt, cases, dev, mhz, parent_csrc,
                                            (cases[0][0], loop_case[0]))
    times = {}
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib_fn = itt._kernel().ilqr_tracking_mpc_time
    for what, buf, args in (cases[0], loop_case):
        out = torch.empty_like(itt.update(buf, *args))
        ms, wrapper_ms = launcher_times(
            "ilqr_tracking_mpc_time", what,
            lambda: lib_fn(buf.data_ptr(), out.data_ptr(), *args, stream),
            lambda: itt.update(buf, *args), 50)
        plain_ms = cuda_ms(lambda: itt.update_reference(buf, *args), 2)
        its = iterations[what]
        bound = itt.bound_ms(MPC_TIME_H, 128, MPC_TIME_T, its)
        chain = itt.chain_ms(MPC_TIME_H, MPC_TIME_T, its, cycles, mhz)
        times[what] = dict(ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                           bound=bound, chain=chain, iterations=its,
                           phases_us=phases[what], parent=parent.get(what))
        print(f"ilqr_tracking_mpc_time {what} at H={MPC_TIME_H}, "
              f"T={MPC_TIME_T}, {its} iterations: kernel {ms:.4f} ms "
              f"(wrapper {wrapper_ms:.4f}), plain {plain_ms:.4f} ms; "
              f"bound_ms {bound[0]:.6f} ({bound[1]}), chain_ms {chain:.4f}")
    return dict(err=max_err, times=times, loop=times[loop_case[0]])


def mpc_time_kernel_checks(itt, cases, dev, mhz, parent_csrc, profiled):
    """The time-indexed MPC's profiling instantiation on ``cases`` ((what,
    packed input, args)): bit-equal to the plain instantiation (a
    difference raises), a "phases" line for each case named in
    ``profiled``; and (with ``parent_csrc``) the bare launcher against
    another version's on every case, every bit (a difference raises), in
    turns, with that version's "phases" lines where it has a profiling
    entry.  Returns ({what: us by phase}, {what: (parent, new, new, parent)
    ms} of the first parent)."""
    import ctypes
    import torch
    from tpl_tpu_torch import _build
    from tpl_tpu_torch.optim import ilqr

    phases = {}
    for what, buf, args in cases:
        got = itt.update(buf, *args)
        prof, cycles = itt.profile(buf, *args)
        torch.cuda.synchronize()
        if not torch.equal(got, prof):
            raise AssertionError(f"{what}: the time MPC's profiling "
                                 "instantiation's result differs")
        if what in profiled:
            its = itt.unpack_outputs(got.cpu().numpy(),
                                     MPC_TIME_H)["iterations"]
            phases[what] = phase_line("ilqr_tracking_mpc_time", what, ilqr,
                                      cycles, its, mhz)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = itt._kernel()
    parent_times = {}
    for k, csrc in enumerate(parents_with(parent_csrc,
                                          "ilqr_tracking_mpc_time")):
        plib = compare_with_parent(
            "ilqr_tracking_mpc_time", lib.ilqr_tracking_mpc_time, csrc,
            [(what, itt.update(buf, *args),
              lambda fn, out, buf=buf, args=args: fn(
                  buf.data_ptr(), out.data_ptr(), *args, stream))
             for what, buf, args in cases],
            times=parent_times if k == 0 else None)
        if not hasattr(plib, "ilqr_tracking_mpc_time_profile"):
            continue
        fn = plib.ilqr_tracking_mpc_time_profile
        fn.restype = ctypes.c_int
        fn.argtypes = lib.ilqr_tracking_mpc_time_profile.argtypes
        _build.prepare(plib, "ilqr_tracking_mpc_time")
        for what, buf, args in cases:
            if what not in profiled:
                continue
            out = torch.empty_like(itt.update(buf, *args))
            cyc = torch.zeros(len(ilqr.PHASES), dtype=torch.int64,
                              device=dev)
            if fn(buf.data_ptr(), out.data_ptr(), cyc.data_ptr(), *args,
                  stream):
                raise RuntimeError("the parent's profiling launch failed")
            if not torch.equal(out, itt.update(buf, *args)):
                raise AssertionError(f"{what}: the profiling instantiation "
                                     f"in {csrc} differs")
            its = itt.unpack_outputs(out.cpu().numpy(),
                                     MPC_TIME_H)["iterations"]
            phase_line("ilqr_tracking_mpc_time", f"{what}, the source in "
                       f"{csrc}", ilqr, dict(zip(ilqr.PHASES,
                                                 cyc.cpu().tolist())),
                       its, mhz)
    return phases, parent_times


def tplsim_phase():
    """``python -m tpl_tpu_torch.simulation.tplsim run --headless
    --no-reload`` on demo/country_follow for TPLSIM_TICKS ticks, on the card
    (no ``--cpu``), as a child process run to its end: exit code 0 (zero
    rule violations) and its summary."""
    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "tpl_tpu_torch.simulation.tplsim", "run",
           "--scenario", "demo/country_follow", "--headless", "--no-reload",
           "--max-ticks", str(TPLSIM_TICKS)]
    env = dict(os.environ, PYTHONPATH=root)
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=root, env=env, capture_output=True,
                         text=True, timeout=600)
    wall = time.perf_counter() - t0
    lines = res.stdout.strip().splitlines()
    print(f"tplsim run (exit code {res.returncode}, {wall:.1f} s): "
          + " | ".join(line.strip() for line in lines[-4:]))
    if res.returncode != 0:
        raise AssertionError(f"tplsim run exited {res.returncode}:\n"
                             f"{res.stdout[-2000:]}\n{res.stderr[-4000:]}")
    if f"ticks={TPLSIM_TICKS}" not in res.stdout \
            or "rule violations: 0" not in res.stdout:
        raise AssertionError(f"tplsim run summary:\n{res.stdout[-2000:]}")


def record_replay_phase():
    """SimRecorder over RECORD_TICKS ticks of the vendored loop on
    demo/country_follow (on the card), written under build/, then
    load_recording and SimReplay stepping it into a fresh store: every
    recorded state equal to the loop's, state for state."""
    import shutil
    import torch
    from tpl_tpu_torch.simulation import (SimRecorder, SimReplay,
                                          SimStandalone, load_recording)
    from tpl_tpu_torch.util import Store

    sim = SimStandalone(app_id="smoke_record",
                        scenario_path="demo/country_follow")
    with sim.core.sh_state.lock():
        ss = sim.core.sh_state.sim
        ss.settings.running = True
        ss.settings.use_real_time = False
        ss.rule_checker.enable = True
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "smoke_recording")
    shutil.rmtree(path, ignore_errors=True)
    rec = SimRecorder(sim, path, dt_state_log=0.01)
    seen = []
    for _ in range(RECORD_TICKS):
        sim.update()
        torch.cuda.synchronize()
        rec.capture()
        with sim.core.sh_state.lock():
            s = sim.core.sh_state.sim
            seen.append((s.t, s.ego.x, s.ego.y, s.ego.v))
    rec.finish()
    recording = load_recording(path)
    states = [(s.t, s.ego.x, s.ego.y, s.ego.v) for s in recording.sim_states]
    if states != seen or len(recording.runtime_planner) != RECORD_TICKS:
        raise AssertionError("the recording differs from the loop")
    store = Store()
    rep = SimReplay(app_id="smoke_replay", recording_path=path,
                    sim_store=store)
    with rep.sh_replay.lock():
        rep.sh_replay.state.sleep_time = 0.0
    for k in range(1, RECORD_TICKS):
        if rep.update() != k:
            raise AssertionError(f"replay step {k}")
        with store.lock():
            s = store.sim
            if (s.t, s.ego.x, s.ego.y, s.ego.v) != seen[k]:
                raise AssertionError(f"replay step {k}: another state")
    rt = np.array(recording.runtime_planner) * 1e3
    print(f"record and replay: {RECORD_TICKS} ticks recorded to t="
          f"{seen[-1][0]:.2f} s (ego x {seen[-1][1]:.4f} v {seen[-1][3]:.4f}),"
          f" read back and replayed state for state; recorded planner "
          f"runtime ms median {np.median(rt):.3f}, max {np.max(rt):.3f}")


def build_generic_parents(dirs, result):
    """Builds, for each directory of ``dirs`` that holds another
    ``ilqr_generic.cu`` (with the headers it includes), its native library
    and the genopt MPC's generated float64 source compiled against its
    headers, one ``nvcc`` each, all started together (no lock of
    ``_build`` held, so that the phases beside it load their libraries);
    the library paths by directory into result["libs"], the seconds into
    result["s"], or the exception into result["error"]."""
    import torch
    from tpl_tpu_torch import _build, scenes
    from tpl_tpu_torch.optim import genopt
    from tpl_tpu_torch.optim import ilqr_generic as ig

    t0 = time.perf_counter()
    try:
        spec = genopt.make_problem(scenes.genopt_mpc_config())[0].generated
        text = ig.source_text(spec, torch.float64)
        jobs, libs = [], {}
        for d in dirs:
            native = _build._paths("ilqr_generic", d)
            stem = os.path.join(_build.BUILD_DIR, "parent_genopt_" + hashlib
                                .sha1((os.path.abspath(d) + text).encode())
                                .hexdigest()[:16])
            with open(stem + ".cu", "w") as f:
                f.write(text)
            jobs += [("ilqr_generic", *native, ()),
                     ("genopt_mpc", stem + ".cu", stem + ".so", ("-I", d))]
            libs[d] = (native[1], stem + ".so")
        _build._nvcc([j for j in jobs if not os.path.exists(j[2])],
                     log=False)
        result["libs"] = libs
        result["s"] = time.perf_counter() - t0
    except Exception as e:      # raised again by the phase that needs it
        result["error"] = e


def generic_parent_libs(parent_build):
    """The parent libraries of build_generic_parents, bound: (dir, native,
    generated) for each; the parents' launchers take the tree's
    arguments."""
    if not parent_build:
        return []
    parent_build["thread"].join()
    if "error" in parent_build:
        raise parent_build["error"]
    out = []
    for d, paths in parent_build["libs"].items():
        libs = []
        for path in paths:
            lib = ctypes.CDLL(path)
            lib.ilqr_generic_update.restype = ctypes.c_int
            lib.ilqr_generic_update.argtypes = (
                [ctypes.c_int] * 3 + [ctypes.c_void_p] * 5
                + [ctypes.c_int] * 6 + [ctypes.c_size_t, ctypes.c_void_p])
            lib.ilqr_generic_split.restype = ctypes.c_size_t
            lib.ilqr_generic_split.argtypes = ([ctypes.c_int] * 4
                                               + [ctypes.c_size_t,
                                                  ctypes.c_int])
            if lib.ilqr_generic_prepare() != 0:
                raise RuntimeError(f"{path}: prepare failed")
            libs.append(lib)
        out.append((d, *libs))
    return out


def generic_launcher(ig, lib, spec, shared, rows, H, n_ref, T, it, lg,
                     integ, smem, parent=False):
    """(out, launch): a launch of the generic kernel into buffers made once,
    through the tree's wrapper library (parent=False: its geometry and
    workspace) or another source's ``lib`` (a grid of B blocks, a block's
    workspace by its own ``ilqr_generic_split``); ``launch()`` raises on a
    CUDA error."""
    import torch

    f64 = int(rows.dtype == torch.float64)
    B = rows.shape[0]
    pid = 0 if spec.struct is not None else spec.id
    if parent:
        ws_words = B * lib.ilqr_generic_split(pid, f64, H, n_ref, smem, 1)
        out = torch.empty((B, ig._size(ig.output_layout(spec, H))),
                          dtype=rows.dtype, device=rows.device)
        ws = torch.empty(max(ws_words, 1), dtype=rows.dtype,
                         device=rows.device)
    else:
        lib, f64, out, ws = ig._prepare_launch(ig._spec(spec), shared, rows,
                                               H, n_ref, integ, smem)
    args = (pid, f64, int(integ), shared.data_ptr(), rows.data_ptr(),
            out.data_ptr(), ws.data_ptr(), None, B, H, n_ref, int(T),
            int(it), int(lg), smem,
            torch.cuda.current_stream(rows.device).cuda_stream)

    # the tree's entry takes the constant tables too (none here)
    entry = lib.ilqr_generic_update if parent else (
        lambda *a: lib.ilqr_generic_update_consts(*a, None))

    def launch():
        err = entry(*args)
        if err:
            raise RuntimeError(f"ilqr_generic launch failed: CUDA error "
                               f"{err}")
    return out, launch


def generic_versus_parents(ig, parents, which, what, spec, shared, rows, H,
                           n_ref, T, it, lg, integ, smem, n, times):
    """Holds the tree's generic kernel against each parent source's on one
    launch's inputs: every result bit for bit (raises otherwise), then
    timed in turns (parent, new, new, parent), into times[what] per parent;
    which: 1 the native library, 2 the generated one."""
    import torch

    new_out, new = generic_launcher(ig, None, spec, shared, rows, H, n_ref,
                                    T, it, lg, integ, smem)
    for d, *libs in parents:
        old_out, old = generic_launcher(ig, libs[which - 1], spec, shared,
                                        rows, H, n_ref, T, it, lg, integ,
                                        smem, parent=True)
        old(), new()
        torch.cuda.synchronize()
        if not torch.equal(old_out, new_out):
            d_max = float((old_out - new_out).abs().nan_to_num(
                float("inf")).max())
            raise AssertionError(f"ilqr_generic {what}: the result differs "
                                 f"from the source in {d} by {d_max:.3e}")
        (a, dd), (b, c) = in_turns(old, new, n)
        print(f"ilqr_generic {what} vs the source in {d}: bits 0.0; ms per "
              f"launch parent {a:.4f}, new {b:.4f}, new {c:.4f}, parent "
              f"{dd:.4f}")
        times.setdefault(what, []).append((a, b, c, dd))


def generic_build_figures(ig, specs):
    """Prints, for each (label, spec, dtype) of ``specs``, the registers and
    local (spill) bytes of its kernels (the block geometry's and the
    resident one's, each with its profiling instantiation; each serves
    every integrator) and returns them by label and dtype."""
    figs = {}
    for label, spec, dtype in specs:
        row = {}
        for geo in ("block", "resident"):
            for prof in (False, True):
                regs, local, _ = ig.attributes(spec, dtype,
                                               geo == "resident", prof)
                row[geo + (" profiling" if prof else "")] = dict(
                    registers=regs, local_bytes=local)
        kind = str(dtype).replace("torch.", "")
        figs[f"{label} {kind}"] = row
        print(f"ilqr_generic build {label} {kind}: " + "; ".join(
                  f"{k} {v['registers']} registers, {v['local_bytes']} B "
                  "local" for k, v in row.items()))
    return figs


def genopt_phase(dev, gen_build, cycles, mhz, parents=()):
    """The sympy front end on the card: the tracking MPC built with
    ``genopt`` (``scenes.genopt_mpc_config``), float64, solved by the kernel
    generated from its config (``csrc/ilqr_generic_body.cuh`` with the
    printed struct), one launch an update, against its plain version on the
    card, the same genopt solve on the CPU and the native problem's kernel
    solve (a ``trajectory_tracking_mpc`` Solver of the same capacity, its
    own kernel), at GENOPT_X_ATOL / GENOPT_COST_RTOL; prints the generated
    source's build seconds (its ``nvcc``, started in a thread beside the
    first phases, ``gen_build``), its bare-launcher and wrapper ms, the
    plain version's ms on the card, ``bound_ms`` / ``chain_ms``, the
    shared-memory / workspace split and the kernels' registers; with
    ``parents`` (generic_parent_libs) the launch against each parent
    source's generated kernel, bits and times in turns; then each
    ``optimizers`` factory with a kernel solves once at its horizon of 300
    on the card, through its kernel (the tracking MPCs the generic one)."""
    import torch
    from tpl_tpu_torch import scenes
    from tpl_tpu_torch.optim import genopt, ilqr, ilqr_rstp
    from tpl_tpu_torch.optim import ilqr_generic as ig
    from tpl_tpu_torch.optim import ilqr_tracking_mpc as itm
    from tpl_tpu_torch.optim import ilqr_tracking_mpc_time as itt
    from tpl_tpu_torch.optim import optimizers as opts

    inputs, x0 = scenes.genopt_mpc_solve_inputs()
    from tpl_tpu_torch.optim import problems
    from tpl_tpu_torch.optim.solver import Solver

    cfg = scenes.genopt_mpc_config()
    cfg.horizon_max = GENOPT_HORIZON_MAX

    gen_build["thread"].join()
    if "error" in gen_build:
        raise gen_build["error"]
    make = genopt.build(cfg, dtype=torch.float64)
    spec = make.problem.generated
    if spec is None:
        raise AssertionError("the genopt MPC has no generated struct")
    t0 = time.perf_counter()
    ig._kernel(spec, torch.float64)
    load_s = time.perf_counter() - t0
    print(f"genopt MPC generated kernel: nvcc of the generated source "
          f"{gen_build['s']:.2f} s (started beside the first phases), its "
          f"first use (load and prepare) {load_s:.3f} s")
    log = _build_log(ig._tag(spec))
    if log:
        print(log)

    def run(make, times=2):
        """A cold solve from fresh solvers ``times`` times: the last solver,
        the wall ms of each (ending in a synchronize) and the first one's
        packed inputs."""
        walls, first = [], None
        for _ in range(times):
            opt = make()
            for k, v in inputs.items():
                setattr(opt.params, k, v)
            opt.horizon, opt.step, opt.max_iterations = GENOPT_H, 0.05, 8
            opt.x[0] = x0
            if first is None:
                first = ({k: np.array(v) for k, v in opt._inputs().items()},
                         dict(opt.params._values))
            t0 = time.perf_counter()
            opt.update()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        return opt, walls, first

    before, gen0 = itm.launches, ig.by_problem.get(spec.name, 0)
    card, card_ms, (ins, params) = run(make)
    launches = ig.by_problem.get(spec.name, 0) - gen0
    if (launches != 2 or itm.launches != before
            or card.device.type != "cuda"):
        raise AssertionError(f"{launches} generated-kernel launches for 2 "
                             "genopt updates on the card")
    cpu, cpu_ms, _ = run(genopt.build(cfg, device="cpu", dtype=torch.float64),
                         1)
    mpc_prob, mpc_spec = problems.trajectory_tracking_mpc()
    native, native_ms, _ = run(lambda: Solver(
        mpc_prob, mpc_spec, horizon_max=GENOPT_HORIZON_MAX,
        dtype=torch.float64))
    if itm.launches != before + 2:
        raise AssertionError(f"{itm.launches - before} kernel launches for 2 "
                             "native solves")

    # the kernel and its plain version on the card, on the first solve's
    # packed inputs
    H = cfg.horizon_max
    n_ref = ig.n_ref_of(spec, params)
    buf = torch.from_numpy(ig.pack_inputs(spec, ins, params, 0)).to(dev)
    integ = card.integrator_type          # the Solver's, EULER
    run_args = (H, n_ref, GENOPT_H, 8, 1, integ)
    got = ig.unpack_outputs(spec, ig.update(spec, buf, *run_args)
                            .cpu().numpy(), H)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = ig.update_reference(spec, buf, *run_args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    plain = ig.unpack_outputs(spec, ref.cpu().numpy(), H)
    err = 0.0
    for what, b in (("its plain version on the card", plain),
                    ("the native problem's kernel solve",
                     dict(x=native._x, u=native._u,
                          traj_costs=native.traj_costs,
                          iterations=native.iterations)),
                    ("the same genopt solve on the CPU",
                     dict(x=cpu._x, u=cpu._u, traj_costs=cpu.traj_costs,
                          iterations=cpu.iterations))):
        dx = float(np.max(np.abs(card._x[:GENOPT_H + 1] - b["x"][
            :GENOPT_H + 1])))
        du = float(np.max(np.abs(card._u[:GENOPT_H] - b["u"][:GENOPT_H])))
        dc = abs(card.traj_costs - b["traj_costs"]) / abs(b["traj_costs"])
        print(f"genopt MPC on the card (generated kernel, float64, "
              f"H={GENOPT_H}, 8 iterations) against {what}: max|dx| "
              f"{dx:.3e}, max|du| {du:.3e}, cost rel {dc:.3e}, iterations "
              f"{card.iterations}/{b['iterations']}")
        if not (dx <= GENOPT_X_ATOL and du <= GENOPT_X_ATOL
                and dc <= GENOPT_COST_RTOL):
            raise AssertionError(f"genopt MPC against {what}: beyond the "
                                 "tolerance")
        err = max(err, dx, du)
    if not (np.array_equal(got["x"], card._x) and np.array_equal(
            got["u"], card._u)):
        raise AssertionError("the wrapper's launch and the solver's part")
    if not float(np.abs(card.u).max()) > 1e-3:
        raise AssertionError("the genopt MPC did not move")

    n_sh = ig._size(ig.shared_layout(spec, H, n_ref))
    shared, rows = buf[:n_sh], buf[n_sh:].reshape(1, -1)
    bare_ms, wrapper_ms = launcher_times(
        "genopt MPC generated kernel", f"float64 H={GENOPT_H} of {H}",
        ig.bare(spec, shared, rows, *run_args[:5], integrator=integ),
        lambda: ig.update(spec, buf, *run_args), 20)
    its = got["iterations"]
    bound = ig.bound_ms(spec, H, n_ref, GENOPT_H, its, integrator=integ)
    chain = ig.chain_ms(spec, H, GENOPT_H, its, cycles, mhz, integ)
    sm, ws = ig.split(spec, H, n_ref, torch.float64)
    sm300, ws300 = ig.split(spec, 300, n_ref, torch.float64)
    out, prof = ig.profile(spec, buf, *run_args)
    if not torch.equal(out, ig.update(spec, buf, *run_args)):
        raise AssertionError("genopt MPC: the profiling instantiation parts")
    phase_line("ilqr_generic genopt_mpc", "cold", ilqr, prof, its, mhz)
    parent_ms = {}
    generic_versus_parents(ig, parents, 2, f"genopt MPC single H={GENOPT_H} "
                           f"of {H}", spec, shared, rows, *run_args[:5],
                           integ, ig.SMEM_LIMIT, 20, parent_ms)
    figures = generic_build_figures(ig, [("genopt MPC", spec,
                                          torch.float64)])
    print(f"genopt MPC generated kernel ms: bare launcher {bare_ms:.4f}, "
          f"wrapper {wrapper_ms:.4f}, plain on the card {plain_ms:.1f}; "
          f"bound_ms {bound[0]:.6f} ({bound[1]}), chain_ms {chain:.4f} "
          f"({its} iterations); split at H={H}: {sm} B shared, {ws} B "
          f"workspace a block (H=300: {sm300} / {ws300})")
    print(f"genopt MPC wall ms (ending in a synchronize): card kernel "
          f"{card_ms[0]:.1f} then {card_ms[1]:.1f}, CPU plain "
          f"{cpu_ms[0]:.1f}, native kernel {native_ms[0]:.1f} then "
          f"{native_ms[1]:.1f}")

    counters = {"trajectory_tracking_mpc": (ig, "launches"),
                "trajectory_tracking_mpc_time": (ig, "launches"),
                "lateral_profile": (ilqr_rstp, "launches"),
                "velocity_profile_space": (ilqr_rstp, "launches"),
                "velocity_profile_time": (ig, "launches"),
                "ref_line_smoother_k": (ig, "launches"),
                "ref_line_smoother_dk": (ig, "launches")}
    for name, (mod, attr) in counters.items():
        b = getattr(opts, name)
        o = b()
        if o.horizon_max != opts.HORIZON_MAX:
            raise AssertionError(f"optimizers.{name}: horizon_max "
                                 f"{o.horizon_max} on the card")
        o.horizon = o.horizon_max
        for k in ("ref_step", "ref_dt"):
            if hasattr(o.params, k):
                setattr(o.params, k, 0.5)
        n0 = getattr(mod, attr)
        o.update()
        torch.cuda.synchronize()
        if getattr(mod, attr) != n0 + 1:
            raise AssertionError(f"optimizers.{name}: no kernel launch")
        print(f"optimizers.{name}: {o.dtype}, one {o.route} solve at "
              f"horizon {o.horizon} = its horizon_max ({o.runtime:.1f} ms, "
              f"finite {bool(np.all(np.isfinite(o.x)))})")
    return dict(err=err, card_ms=card_ms, cpu_ms=cpu_ms, native_ms=native_ms,
                parent_ms=parent_ms, figures=figures,
                launches=launches, ms=bare_ms, wrapper_ms=wrapper_ms,
                plain_ms=plain_ms, bound=bound, chain=chain,
                build_s=gen_build["s"], iterations=its,
                split=dict(H=H, shared_bytes=sm, workspace_bytes=ws,
                           H300_shared_bytes=sm300,
                           H300_workspace_bytes=ws300))


def build_genopt_source(result):
    """Builds the genopt MPC's generated kernel source for float64 (its
    nvcc), the seconds into result["s"], or the exception into
    result["error"]."""
    import torch
    from tpl_tpu_torch import scenes
    from tpl_tpu_torch.optim import genopt
    from tpl_tpu_torch.optim import ilqr_generic as ig

    t0 = time.perf_counter()
    try:
        spec = genopt.make_problem(scenes.genopt_mpc_config())[0].generated
        ig.build_generated([spec], torch.float64)
        result["s"] = time.perf_counter() - t0
    except Exception as e:      # raised again by the genopt phase
        result["error"] = e


def _build_log(name):
    """The ptxas lines (registers, spills) of a library built in this run."""
    from tpl_tpu_torch import _build

    return "\n".join(line for line in _build.BUILD_LOG.get(name, "")
                     .splitlines() if "Used" in line or "spill" in line)


def generic_case_buf(ig, name, H, T, warm, seed, dtype, dev):
    """A native problem's seeded packed input on ``dev``
    (``scenes.generic_native_case``): (buf, max_iterations)."""
    import torch
    from tpl_tpu_torch import scenes

    inputs, params, mu, it = scenes.generic_native_case(name, H, T, warm,
                                                        seed)
    host = ig.pack_inputs(name, inputs, params, mu, dtype)
    return torch.from_numpy(host).to(dev), it


def compare_generic(ig, name, got, want, H, dtype, what):
    """Generic kernel vs plain results (packed, any device): raises beyond
    the float32 RSTP tolerances or, in float64, GENERIC_TOL with equal
    mu_step and iterations; returns the largest |x|, |u| difference."""
    g = ig.unpack_outputs(name, got.double().cpu().numpy(), H)
    w = ig.unpack_outputs(name, want.double().cpu().numpy(), H)
    d = max(float(np.max(np.abs(g[k] - w[k]))) for k in ("x", "u", "lam"))
    dc = abs(g["traj_costs"] - w["traj_costs"]) / max(abs(w["traj_costs"]),
                                                       1e-30)
    if dtype == "float64":
        ok = (d <= GENERIC_TOL * max(1.0, float(np.max(np.abs(w["x"]))))
              and dc <= GENERIC_TOL and g["mu_step"] == w["mu_step"]
              and g["iterations"] == w["iterations"])
    else:
        ok = d <= RSTP_X_ATOL and dc <= RSTP_COST_RTOL
    if not (ok and np.all(np.isfinite(g["x"]))):
        raise AssertionError(f"{name} {what}: kernel and plain part: max "
                             f"diff {d:.3e}, cost rel {dc:.3e}, iterations "
                             f"{g['iterations']}/{w['iterations']}")
    return d, g["iterations"]


def generic_phase(ig, dev, cycles, mhz, parents=()):
    """The generic AL-iLQR kernel (``csrc/ilqr_generic.cu``) on the native
    problems without a kernel of their own, at H = 250 and 300 (at 300
    with a shared-memory limit of GENERIC_SMALL_SMEM, so that a block's
    arrays lie in the global workspace), cold with EULER and warm with HEUN
    (the seeded cases of the card tests), float32 (the factories' dtype, at
    the RSTP tolerance) and float64 (at GENERIC_TOL), each against its plain
    version on the card; on the cold float32 cases times, bounds, the split
    and a "phases" line (the profiling instantiation bit-equal); then the batch (``optim.batched`` on CUDA tensors) at
    B = 1, 64 and 2,048 of ``ref_line_smoother_k`` (H=250) and of the
    genopt MPC (H=60), float64: every scenario bit-equal to its single
    launch, against the plain batched update on the card at B <= 64;
    times through the bare launcher and the wrapper, the geometry the
    launcher picks (a block a scenario, or resident warps: slots a block,
    blocks an SM, a slot's shared and workspace bytes) and, at B = 2,048, a
    "phases" line of the warp that solves scenario 0.  The batches are
    float64: in float32 a scenario's line-search acceptance near the stop
    is decided by rounding, and the batched plain update sums in another
    order than the kernel, so one scenario in 64 may part by a metre.
    With ``parents`` (generic_parent_libs) every case above, and the RSTP
    profiles (``scenes.GENERIC_RSTP``) at the same shapes, is held bit for
    bit to each parent source's launch and timed in turns with it."""
    import torch
    from tpl_tpu_torch import scenes
    from tpl_tpu_torch.optim import batched, genopt, ilqr

    f32, f64 = torch.float32, torch.float64
    err, times, parent_ms = 0.0, {}, {}
    for name in scenes.GENERIC_NATIVE + scenes.GENERIC_RSTP:
        if name in scenes.GENERIC_RSTP and not parents:
            continue
        for H in GENERIC_H:
            smem = GENERIC_SMALL_SMEM if H == 300 else ig.SMEM_LIMIT
            for warm, integ in ((False, ilqr.EULER), (True, ilqr.HEUN)):
                T = H - 20 if warm else H
                what = (f"H={H} T={T} {'warm' if warm else 'cold'} "
                        f"{'HEUN' if integ else 'EULER'}")
                for dtype in (f32, f64):
                    buf, it = generic_case_buf(ig, name, H, T, warm, H + warm,
                                               dtype, dev)
                    run = (H, 512, T, it, 1, integ)
                    n_sh = ig._size(ig.shared_layout(name, H, 512))
                    generic_versus_parents(
                        ig, parents, 1, f"{name} {what} {dtype}",
                        ig.NATIVE[name], buf[:n_sh],
                        buf[n_sh:].reshape(1, -1), *run, smem, 5, parent_ms)
                    if name in scenes.GENERIC_RSTP:
                        continue
                    n0 = ig.launches
                    out = ig.update(name, buf, *run, smem_limit=smem)
                    if ig.launches != n0 + 1:
                        raise AssertionError(f"{name}: no launch")
                    t0 = time.perf_counter()
                    ref = ig.update_reference(name, buf, *run)
                    torch.cuda.synchronize()
                    plain_ms = (time.perf_counter() - t0) * 1e3
                    kind = str(dtype).replace("torch.", "")
                    d, its = compare_generic(ig, name, out, ref, H, kind,
                                             what)
                    err = max(err, d) if dtype == f64 else err
                    sm, ws = ig.split(name, H, 512, dtype, smem)
                    print(f"ilqr_generic {name} {what} {kind}: max diff to "
                          f"plain on the card {d:.3e}, {its} iterations, "
                          f"plain {plain_ms:.1f} ms; split {sm} B shared + "
                          f"{ws} B workspace (limit {smem} B)")
                    if warm or dtype == f64:
                        continue
                    # the factories' dtype, cold: times, bounds, phases
                    n_sh = ig._size(ig.shared_layout(name, H, 512))
                    sh, rw = buf[:n_sh], buf[n_sh:].reshape(1, -1)
                    bare, wrap = launcher_times(
                        f"ilqr_generic {name}", f"{what} float32",
                        ig.bare(name, sh, rw, *run[:5], integrator=integ,
                                smem_limit=smem),
                        lambda: ig.update(name, buf, *run, smem_limit=smem),
                        10)
                    t = times[(name, H)] = dict(
                        ms=bare, wrapper_ms=wrap, plain_ms=plain_ms,
                        iterations=its,
                        bound=ig.bound_ms(name, H, 512, T, its,
                                          integrator=integ, dtype=f32),
                        chain=ig.chain_ms(name, H, T, its, cycles, mhz,
                                          integ, f32),
                        shared_bytes=sm, workspace_bytes=ws)
                    print(f"ilqr_generic {name} {what} float32: bound_ms "
                          f"{t['bound'][0]:.6f} ({t['bound'][1]}), chain_ms "
                          f"{t['chain']:.4f}")
                    pout, prof = ig.profile(name, buf, *run)
                    if not torch.equal(pout, out):
                        raise AssertionError(f"{name}: the profiling "
                                             "instantiation parts")
                    phase_line(f"ilqr_generic {name}", what, ilqr, prof, its,
                               mhz)
    print(_build_log("ilqr_generic_f32") + "\n"
          + _build_log("ilqr_generic_f64"))
    figures = generic_build_figures(
        ig, [(n, ig.NATIVE[n], d) for n in ig.NATIVE for d in (f32, f64)])

    # the batch through optim.batched on CUDA tensors
    gspec = genopt.make_problem(scenes.genopt_mpc_config())[0].generated
    batches = {}
    for which in ("ref_line_smoother_k", "genopt_mpc"):
        for B in GENERIC_BATCHES:
            rng = np.random.default_rng(B)
            if which == "genopt_mpc":
                spec, H, n_ref, dtype, integ = gspec, 60, 128, \
                    torch.float64, ilqr.HEUN
                inputs, params, _ = scenes.genopt_mpc_case(False, 1)
                spread = np.array([1, 1, 0.2, 0.1, 3, 0, 0.5])[:, None]
                it = 8
            else:
                spec, H, n_ref, dtype, integ = ig.NATIVE[which], 250, 512, \
                    f64, ilqr.EULER
                inputs, params, _, it = scenes.generic_native_case(
                    which, H, H, False, 1)
                spread = np.array([0.2, 0.2, 0.02])[:, None]
            t = lambda a: torch.as_tensor(np.asarray(a, np.float64),
                                          dtype=dtype, device=dev)
            tp = {k: t(v) for k, v in params.items()
                  if k in spec.scalars + spec.tables}
            cfg = dict(u_min=t(inputs["u_lims"][..., 0]),
                       u_max=t(inputs["u_lims"][..., 1]),
                       barrier_weight=t(inputs["bw_lim"][:, 0]),
                       lg_mult_limit=t(inputs["bw_lim"][:, 1]),
                       dt=t(inputs["cfg_f"][0]),
                       min_rel_cost_change=t(inputs["cfg_f"][1]), T=H,
                       max_iterations=it, max_lg_iterations=1)
            x = torch.zeros((H + 1, spec.nx, B), dtype=dtype, device=dev)
            u = torch.zeros((H, spec.nu, B), dtype=dtype, device=dev)
            lam_ = torch.zeros((H, spec.ncl, B), dtype=dtype, device=dev)
            mu = torch.zeros(B, dtype=torch.int32, device=dev)
            x0 = t(inputs["x"][0][:, None]
                   + rng.normal(0.0, 1.0, (spec.nx, B)) * spread)
            upd = batched.make_batched_update_fn(spec.problem, H, B, integ,
                                                 dtype)
            n0 = ig.launches
            got = upd(x, u, lam_, mu, x0, tp, cfg, iterations=True)
            torch.cuda.synchronize()
            if ig.launches != n0 + 1:
                raise AssertionError(f"{which} B={B}: {ig.launches - n0} "
                                     "launches")
            shared, rows = ig.pack_inputs_batched(spec, x, u, lam_, mu, x0,
                                                  tp, cfg, dtype)
            out = ig.launch(spec, shared, rows, H, n_ref, H, it,
                            integrator=integ)
            singles = ig.rows_of_batch(shared, rows)
            for b in range(B):
                one = ig.update(spec, singles[b].contiguous(), H, n_ref, H,
                                it, 1, integ)
                if not torch.equal(one, out[b]):
                    raise AssertionError(f"{which} B={B}: scenario {b} "
                                         "parts from its single launch")
            generic_versus_parents(ig, parents, 2 if spec.struct else 1,
                                   f"batch {which} B={B}", spec, shared, rows,
                                   H, n_ref, H, it, 1, integ, ig.SMEM_LIMIT,
                                   3 if B > 64 else 10, parent_ms)
            geo = ig.geometry(spec, B, H, n_ref, dtype)
            unit = ig.split(spec, H, n_ref, dtype, B=B)
            print(f"ilqr_generic batch {which} B={B}: "
                  f"{'resident warps' if geo['resident'] else 'a block a scenario'}"
                  f", {geo['slots']} scenarios a block, {geo['per_sm']} "
                  f"blocks an SM, {geo['blocks']} blocks, {geo['smem']} B "
                  f"shared a block; a {'slot' if geo['resident'] else 'block'}"
                  f": {unit[0]} B shared, {unit[1]} B workspace")
            phases = None
            if geo["resident"]:
                pout, prof = ig.profile_batch(spec, shared, rows, H, n_ref, H,
                                              it, 1, integ)
                if not torch.equal(pout, out):
                    raise AssertionError(f"{which} B={B}: the profiling "
                                         "instantiation parts")
                phases = phase_line(f"ilqr_generic batch {which}",
                                    f"B={B} scenario 0", ilqr, prof,
                                    int(got[5][0]), mhz)
            line = ""
            plain_ms = None
            if B <= 64:
                t0 = time.perf_counter()
                want = upd.reference(x, u, lam_, mu, x0, tp, cfg,
                                     iterations=True)
                torch.cuda.synchronize()
                plain_ms = (time.perf_counter() - t0) * 1e3
                d = max(float((g.double() - w.double()).abs().max())
                        for g, w in zip(got[:3], want[:3]))
                tol = (GENERIC_TOL * float(want[0].abs().max())
                       if dtype == torch.float64 else RSTP_X_ATOL)
                if not d <= tol:
                    raise AssertionError(f"{which} B={B}: the batch and the "
                                         f"plain batched update part by {d}")
                err = max(err, d)
                line = (f", max diff to the plain batched update on the card "
                        f"{d:.3e} (plain {plain_ms:.1f} ms)")
            its = got[5].cpu().numpy()
            bare, wrap = launcher_times(
                f"ilqr_generic batch {which}", f"B={B}",
                ig.bare(spec, shared, rows, H, n_ref, H, it,
                        integrator=integ),
                lambda: upd(x, u, lam_, mu, x0, tp, cfg), 5)
            bound = ig.bound_ms(spec, H, n_ref, H, its, integrator=integ,
                                dtype=dtype)
            chain = ig.chain_ms(spec, H, H, int(its.max()), cycles, mhz,
                                integ, dtype)
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            resident = sms * geo["per_sm"] * geo["slots"]
            floor = (ig.design_floor_ms(spec, H, H, its, its, cycles, mhz,
                                        resident, integ, dtype)
                     if geo["resident"] else None)
            batches[(which, B)] = dict(
                ms=bare, wrapper_ms=wrap, plain_ms=plain_ms, bound=bound,
                chain=chain, solves_per_s=B / wrap * 1e3,
                iterations_max=int(its.max()), geometry=geo,
                unit_bytes=unit, floor=floor, phases=phases,
                parent_ms=parent_ms.get(f"batch {which} B={B}"))
            print(f"ilqr_generic batch {which} B={B} ({dtype}): every "
                  f"scenario bit-equal to its single launch{line}; "
                  f"iterations {int(its.min())}-{int(its.max())}; ms bare "
                  f"{bare:.4f}, wrapper {wrap:.4f}, {B / wrap * 1e3:.0f} "
                  f"solves/s; bound_ms {bound[0]:.6f} ({bound[1]}), "
                  f"chain_ms {chain:.4f}"
                  + (f", this design's floor {floor:.4f} (each scenario's "
                     f"chain with a round an iteration, {resident} warps)"
                     if floor is not None else ""))
    return dict(err=err, times=times, batches=batches, parent_ms=parent_ms,
                figures=figures)


def tracking_generic_phase(ig, itm, itt, dev, cycles, mhz):
    """The two tracking MPCs through the generic kernel: each
    ``optimizers`` factory's solver (horizon_max 300) at H = 200 and 300
    on seeded warm starts (``scenes.genopt_mpc_case``,
    ``scenes.mpc_time_generic_case``; HEUN, 8 iterations): one generic
    launch a solve and none of the MPC's own kernel, the result against the
    plain update on the card at GENERIC_TOL (x scaled by its largest
    magnitude) with equal mu_step and iterations, the bare launcher's and
    the plain version's ms, bound_ms / chain_ms, the split; then the batched
    time-indexed MPC (``optim.batched`` on CUDA tensors, H=60, 8 iterations,
    HEUN, cold) at B = 64 and 2,048: one launch, every scenario bit-equal
    to its single launch, against the plain batched update on the card at
    B = 64, the geometry, times and bounds."""
    import torch
    from tpl_tpu_torch import scenes
    from tpl_tpu_torch.optim import batched, ilqr, optimizers, problems

    f64 = torch.float64
    err, singles, batches, launches = 0.0, {}, {}, 0
    for name in ("trajectory_tracking_mpc", "trajectory_tracking_mpc_time"):
        own = itm if name == "trajectory_tracking_mpc" else itt
        for H in TRACKING_H:
            opt = getattr(optimizers, name)()
            if opt.route != "ilqr_generic":
                raise AssertionError(f"{name}: route {opt.route}")
            if name == "trajectory_tracking_mpc":
                inputs, params, mu = scenes.genopt_mpc_case(True, 7, H)
            else:
                inputs, params, mu = scenes.mpc_time_generic_case(H, 7, True)
            cap = opt.horizon_max
            pad = lambda a: np.pad(a, ((0, cap - H),) + ((0, 0),) * (
                a.ndim - 1))
            for k, v in params.items():
                setattr(opt.params, k, v)
            opt.horizon, opt.step, opt.max_iterations = H, 0.05, 8
            opt.integrator_type = ilqr.HEUN
            opt.load_state(pad(inputs["x"]), pad(inputs["u"]),
                           pad(inputs["lam"]), mu)
            opt.u_min = inputs["u_lims"][..., 0]
            opt.u_max = inputs["u_lims"][..., 1]
            opt.barrier_weight = inputs["bw_lim"][:, 0]
            opt.lg_mult_limit = inputs["bw_lim"][:, 1]
            state = {k: np.array(v) for k, v in opt._inputs().items()}
            n0, own0 = ig.by_problem.get(name, 0), own.launches
            opt.update()
            torch.cuda.synchronize()
            if ig.by_problem.get(name, 0) != n0 + 1 or own.launches != own0:
                raise AssertionError(f"{name} H={H}: not one generic launch")
            launches += 1
            n_ref = ig.n_ref_of(name, opt.params._values)
            buf = torch.from_numpy(ig.pack_inputs(
                name, state, opt.params._values, mu)).to(dev)
            run = (cap, n_ref, H, 8, 1, ilqr.HEUN)
            got = ig.update(name, buf, *run)
            t0 = time.perf_counter()
            ref = ig.update_reference(name, buf, *run)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            if not (np.array_equal(opt._x, ig.unpack_outputs(
                    name, got.cpu().numpy(), cap)["x"])):
                raise AssertionError(f"{name} H={H}: the solver's and the "
                                     "wrapper's launch part")
            d, its = compare_generic(ig, name, got, ref, cap, "float64",
                                     f"H={H} through the factory")
            err = max(err, d)
            n_sh = ig._size(ig.shared_layout(name, cap, n_ref))
            bare, wrap = launcher_times(
                f"ilqr_generic {name}", f"H={H} of {cap} float64",
                ig.bare(name, buf[:n_sh], buf[n_sh:].reshape(1, -1),
                        *run[:5], integrator=ilqr.HEUN),
                lambda: ig.update(name, buf, *run), 10)
            bound = ig.bound_ms(name, cap, n_ref, H, its,
                                integrator=ilqr.HEUN)
            chain = ig.chain_ms(name, cap, H, its, cycles, mhz, ilqr.HEUN)
            split = ig.split(name, cap, n_ref, f64)
            out, prof = ig.profile(name, buf, *run)
            if not torch.equal(out, got):
                raise AssertionError(f"{name}: the profiling instantiation "
                                     "parts")
            phases = phase_line(f"ilqr_generic {name}", f"H={H}", ilqr, prof,
                                its, mhz)
            singles[(name, H)] = dict(ms=bare, wrapper_ms=wrap,
                                      plain_ms=plain_ms, bound=bound,
                                      chain=chain, iterations=its,
                                      split=split, phases=phases, err=d)
            print(f"ilqr_generic {name} H={H} of {cap} (the factory's "
                  f"solver, generic kernel): max diff to plain on the card "
                  f"{d:.3e}, {its} iterations, plain {plain_ms:.1f} ms; "
                  f"bound_ms {bound[0]:.6f} ({bound[1]}), chain_ms "
                  f"{chain:.4f}; split {split[0]} B shared + {split[1]} B "
                  "workspace")

    name = "trajectory_tracking_mpc_time"
    spec = ig.NATIVE[name]
    H, it, integ = MPC_H, 8, ilqr.HEUN
    inputs, params, _ = scenes.mpc_time_generic_case(H, 3)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=dev)
    tp = {k: t(v) for k, v in params.items()}
    cfg = dict(u_min=t(inputs["u_lims"][..., 0]),
               u_max=t(inputs["u_lims"][..., 1]),
               barrier_weight=t(inputs["bw_lim"][:, 0]),
               lg_mult_limit=t(inputs["bw_lim"][:, 1]),
               dt=t(inputs["cfg_f"][0]),
               min_rel_cost_change=t(inputs["cfg_f"][1]), T=H,
               max_iterations=it, max_lg_iterations=1)
    for B in TIME_BATCHES:
        rng = np.random.default_rng(B)
        x = torch.zeros((H + 1, 6, B), dtype=f64, device=dev)
        u = torch.zeros((H, 2, B), dtype=f64, device=dev)
        lam_ = torch.zeros((H, 4, B), dtype=f64, device=dev)
        mu = torch.zeros(B, dtype=torch.int32, device=dev)
        x0 = t(inputs["x"][0][:, None] + rng.normal(0.0, 0.2, (6, B)))
        upd = batched.make_batched_update_fn(
            problems.trajectory_tracking_mpc_time()[0], H, B, integ, f64)
        n0 = ig.launches
        got = upd(x, u, lam_, mu, x0, tp, cfg, iterations=True)
        torch.cuda.synchronize()
        if ig.launches != n0 + 1:
            raise AssertionError(f"batched {name} B={B}: "
                                 f"{ig.launches - n0} launches")
        launches += 1
        shared, rows = ig.pack_inputs_batched(spec, x, u, lam_, mu, x0, tp,
                                              cfg)
        out = ig.launch(spec, shared, rows, H, 128, H, it, 1, integ)
        singles_in = ig.rows_of_batch(shared, rows)
        for b in range(B):
            one = ig.update(spec, singles_in[b].contiguous(), H, 128, H, it,
                            1, integ)
            if not torch.equal(one, out[b]):
                raise AssertionError(f"batched {name} B={B}: scenario {b} "
                                     "parts from its single launch")
        plain_ms, line = None, ""
        if B <= 64:
            t0 = time.perf_counter()
            want = upd.reference(x, u, lam_, mu, x0, tp, cfg,
                                 iterations=True)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            d = max(float((g.double() - w.double()).abs().max())
                    for g, w in zip(got[:3], want[:3]))
            if not (d <= GENERIC_TOL * float(want[0].abs().max())
                    and torch.equal(got[3], want[3])
                    and torch.equal(got[5], want[5])):
                raise AssertionError(f"batched {name} B={B}: the batch and "
                                     f"the plain batched update part by {d}")
            err = max(err, d)
            line = (f", max diff to the plain batched update on the card "
                    f"{d:.3e} (plain {plain_ms:.1f} ms)")
        its = got[5].cpu().numpy()
        geo = ig.geometry(spec, B, H, 128, f64)
        bare, wrap = launcher_times(
            f"ilqr_generic batch {name}", f"B={B}",
            ig.bare(spec, shared, rows, H, 128, H, it, 1, integ),
            lambda: upd(x, u, lam_, mu, x0, tp, cfg), 5)
        bound = ig.bound_ms(spec, H, 128, H, its, integrator=integ)
        chain = ig.chain_ms(spec, H, H, int(its.max()), cycles, mhz, integ)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        floor = (ig.design_floor_ms(spec, H, H, its, its, cycles, mhz,
                                    sms * geo["per_sm"] * geo["slots"],
                                    integ)
                 if geo["resident"] else None)
        batches[B] = dict(ms=bare, wrapper_ms=wrap, plain_ms=plain_ms,
                          bound=bound, chain=chain, floor=floor,
                          solves_per_s=B / wrap * 1e3, geometry=geo,
                          iterations_max=int(its.max()))
        print(f"ilqr_generic batch {name} B={B}: every scenario bit-equal "
              f"to its single launch{line}; iterations {int(its.min())}-"
              f"{int(its.max())}; {'resident warps' if geo['resident'] else 'a block a scenario'}"
              f" ({geo['slots']} a block, {geo['per_sm']} blocks an SM); ms "
              f"bare {bare:.4f}, wrapper {wrap:.4f}, {B / wrap * 1e3:.0f} "
              f"solves/s; bound_ms {bound[0]:.6f} ({bound[1]}), chain_ms "
              f"{chain:.4f}"
              + (f", this design's floor {floor:.4f}" if floor else ""))
    return dict(err=err, singles=singles, batches=batches, launches=launches)


def smooth_only_phase(ig, rstp, itm):
    """The RSTP planner's ``smooth_only`` path on the card: SimStandalone on
    ``demo/country_follow`` with the scenario's own sets and ``smooth_only``
    turned on in the planning store, SMOOTH_TICKS ticks: one
    ``ref_line_smoother_k`` launch of the generic kernel and one
    ``velocity_profile_space`` launch of ``ilqr_rstp`` a replan, finite
    controls, zero violations, the ego moving; prints the replan walls."""
    import torch
    from tpl_tpu_torch.simulation import SimStandalone

    scenario = "demo/country_follow"
    sim = SimStandalone(app_id="smoke_smooth_only", scenario_path=scenario)
    store = sim.planning_app.sh_planners
    with store.lock():
        params = store.path_vel_decomp_planner.params
        check_planning_set(scenario, store.active_planner, params)
        params.smooth_only = True
        check_planning_set(scenario, store.active_planner, params,
                           smooth_only=True)
    planner = sim.planning_app.planners["path_vel_decomp_planner"]
    with sim.core.sh_state.lock():
        ss = sim.core.sh_state.sim
        ss.settings.running = True
        ss.settings.use_real_time = False
        ss.rule_checker.enable = True
        x_start = ss.ego.x
    replans = []
    smooth = planner.path_smoothing.update

    def counted(*a, **k):
        replans.append(1)
        return smooth(*a, **k)

    planner.path_smoothing.update = counted
    plan_ms = []
    ig.by_problem["ref_line_smoother_k"] = 0
    rstp.launches = itm.launches = 0
    try:
        for k in range(SMOOTH_TICKS):
            sim.update()
            torch.cuda.synchronize()
            with store.lock():
                plan_ms.append(store.runtime * 1e3)
                traj = store.trajectory
            with sim.control_app.sh_controllers.lock():
                controls = np.array(sim.control_app.sh_controllers.controls)
            if not np.all(np.isfinite(controls)):
                raise AssertionError(f"smooth_only tick {k}: non-finite "
                                     "controls")
            if len(traj.x) and not np.all(np.isfinite(traj.velocity)):
                raise AssertionError(f"smooth_only tick {k}: no finite "
                                     "plan")
    finally:
        planner.path_smoothing.update = smooth
    smoother = ig.by_problem["ref_line_smoother_k"]
    with sim.core.sh_state.lock():
        s = sim.core.sh_state.sim
        violations = list(s.rule_checker.violations)
        t_end, x_end, v_end = s.t, s.ego.x, s.ego.v
    n = len(replans)
    print(f"rstp smooth_only country_follow: {SMOOTH_TICKS} ticks to "
          f"t={t_end:.2f} s, ego x {x_start:.2f} -> {x_end:.2f}, v "
          f"{v_end:.2f} m/s, {len(violations)} violations, {n} replans, "
          f"launches: ref_line_smoother_k {smoother}, ilqr_rstp "
          f"{rstp.launches}, ilqr_tracking_mpc {itm.launches}; replan wall "
          f"ms median {np.median(plan_ms[1:]):.3f} max "
          f"{np.max(plan_ms[1:]):.3f}")
    if violations:
        raise AssertionError(f"smooth_only: rule violations {violations[:3]}")
    if n < SMOOTH_TICKS - 5 or smoother != n or rstp.launches != n:
        raise AssertionError(f"smooth_only: {smoother} smoother and "
                             f"{rstp.launches} velocity launches for {n} "
                             "replans")
    if not x_end > x_start + 1.0:
        raise AssertionError("smooth_only: the ego did not move")
    return dict(launches=smoother, replans=n, ticks=SMOOTH_TICKS,
                plan_median_ms=float(np.median(plan_ms[1:])),
                plan_max_ms=float(np.max(plan_ms[1:])))


def user_problems():
    """{example module name: (module, the Problem a fresh make_problem
    builds)} of the three examples whose torch problems the tracer takes
    to the generic kernel."""
    from tpl_tpu_torch.examples import (crane_2d, simple_vehicle,
                                        solver_crosscheck)

    return {m.__name__.rsplit(".", 1)[-1]: m for m in (
        crane_2d, simple_vehicle, solver_crosscheck)}


def build_user_sources(result):
    """Traces the three examples' problems (their solvers' param kinds) and
    ``trajectory_tracking_mpc`` and builds the structs' sources the user
    problems' phase launches (the examples in float32, their own dtype, and
    float64; the tracking MPC in float64) in one ``build_generated`` call,
    one ``nvcc`` each, all started together; the seconds into result["s"],
    the specs into result["specs"], or the exception into
    result["error"]."""
    import torch
    from tpl_tpu_torch.optim import ilqr_generic as ig
    from tpl_tpu_torch.optim import problems, trace

    t0 = time.perf_counter()
    try:
        jobs = []
        for name, mod in user_problems().items():
            prob, pspec = mod.make_problem()
            spec = trace.spec(prob, trace.kinds_of_spec(pspec))
            jobs += [(spec, torch.float32), (spec, torch.float64)]
        prob, pspec = problems.trajectory_tracking_mpc()
        jobs.append((trace.spec(prob, trace.kinds_of_spec(pspec)),
                     torch.float64))
        result["trace_s"] = time.perf_counter() - t0
        ig.build_generated([s for s, _ in jobs], [d for _, d in jobs])
        result["specs"] = jobs
        result["s"] = time.perf_counter() - t0
    except Exception as e:      # raised again by the phase that needs it
        result["error"] = e


def user_check(what, got, want, dtype, its_equal=True, tol=None):
    """Two solves' x, u (and iterations, mu_step where its_equal): raises
    beyond ``tol`` (x, u atol scaled by the largest |x|; cost rtol); returns
    (max |dx|, |du|, cost rel)."""
    d = max(float(np.max(np.abs(np.asarray(got[k]) - np.asarray(want[k]))))
            for k in ("x", "u"))
    dc = abs(got["traj_costs"] - want["traj_costs"]) / max(
        abs(want["traj_costs"]), 1e-30)
    scale = max(1.0, float(np.max(np.abs(want["x"]))))
    x_tol, c_tol = tol
    ok = d <= x_tol * scale and dc <= c_tol and np.all(np.isfinite(got["x"]))
    if its_equal:
        ok = ok and (got["iterations"], got["mu_step"]) == (
            want["iterations"], want["mu_step"])
    print(f"  {what}: max|dx|,|du| {d:.3e}, cost rel {dc:.3e}, iterations "
          f"{got['iterations']}/{want['iterations']} (tolerance {x_tol:g} "
          f"x {scale:.1f}, cost {c_tol:g})")
    if not ok:
        raise AssertionError(f"{what}: beyond the tolerance")
    return d


def user_tolerance(name, dtype):
    """(x tol, cost tol, iterations equal) of a user problem's kernel solve
    against its plain version in ``dtype`` (see USER_TOL)."""
    import torch

    if dtype == torch.float64:
        if name == "simple_vehicle":
            return USER_VEHICLE_TOL, USER_VEHICLE_TOL, True
        return GENERIC_TOL, GENERIC_TOL, True
    if name == "simple_vehicle":
        return USER_VEHICLE_F32_TOL, USER_VEHICLE_F32_TOL, True
    return USER_F32_TOL, USER_F32_TOL, False


def user_solver(mod, dtype, device):
    """An example's own Solver in ``dtype`` on ``device``; the vehicle's
    float32 one stops at USER_VEHICLE_F32_ITERATIONS (see USER_TOL)."""
    import torch

    opt = mod.make_solver(device=device)
    opt.dtype = dtype
    if mod.__name__.endswith("simple_vehicle") and dtype == torch.float32:
        opt.max_iterations = USER_VEHICLE_F32_ITERATIONS
    return opt


def user_problem_phase(ig, dev, cycles, mhz, user_build):
    """User problems through the generic kernel: the three examples' torch
    problems (``tpl_tpu_torch.examples.{crane_2d, simple_vehicle,
    solver_crosscheck}``), traced into the generic kernel's struct
    (``tpl_tpu_torch/optim/trace.py``) and built by ``build_user_sources``
    beside the first phases.  First the main path: each example's ``main``
    on the card (its own acceptance: the crane at its target, the
    vehicle's path finite, the unicycle within 5e-2 of scipy's SLSQP), the
    counts set to 0 just before and read just after: one ``ilqr_generic``
    launch an update.  Then each example's own solve, float32 (its dtype)
    and float64, through the Solver (``route == "ilqr_generic"``, one
    launch an update) against the plain iLQR on the card and on the CPU
    (USER_TOL); float32 timed through the bare launcher and the wrapper,
    with ``bound_ms`` / ``chain_ms`` and a "phases" line.  Then the crane's
    batch (``optim.batched`` on CUDA tensors, float64) at each of
    USER_BATCHES: one launch, every scenario bit-equal to its single
    launch, four scenarios within GENERIC_TOL of ``update.reference`` on
    the CPU; timed, solves/s, bounds and the design floor.  Then the traced
    ``trajectory_tracking_mpc`` (H=60, float64, HEUN, 8 iterations, cold
    and warm) against its hand-written struct through ``ilqr_generic``
    (GENERIC_TOL, equal iterations) and against ``csrc/ilqr_tracking_mpc.cu``
    (GENOPT_X_ATOL / GENOPT_COST_RTOL), the three timed in turns."""
    import torch
    from tpl_tpu_torch import scenes
    from tpl_tpu_torch.optim import batched, ilqr, problems, trace
    from tpl_tpu_torch.optim import ilqr_tracking_mpc as itm

    f32, f64 = torch.float32, torch.float64
    user_build["thread"].join()
    if "error" in user_build:
        raise user_build["error"]
    print(f"user problems: traced in {user_build['trace_s']:.2f} s; "
          f"{len(user_build['specs'])} sources (nvcc, one each, started "
          f"together beside the first phases) built in "
          f"{user_build['s']:.2f} s")
    figures = generic_build_figures(
        ig, [(f"traced {s.name}", s, d) for s, d in user_build["specs"]])
    mods = user_problems()

    # the main path: the examples' own mains on the card
    main_launches, main_ms = {}, {}
    for name, mod in mods.items():
        prob_name = mod.make_problem()[0].name
        ig.by_problem[prob_name] = 0
        t0 = time.perf_counter()
        mod.main([])
        torch.cuda.synchronize()
        main_ms[name] = (time.perf_counter() - t0) * 1e3
        main_launches[name] = ig.by_problem[prob_name]
        want = 2 if name == "solver_crosscheck" else 1
        if main_launches[name] != want:
            raise AssertionError(f"{name}: {main_launches[name]} generic "
                                 f"launches for {want} updates")
        print(f"{name} main on the card: its checks passed, "
              f"{main_launches[name]} ilqr_generic launches for {want} "
              f"updates, {main_ms[name]:.1f} ms")

    # each example's own solve against the plain iLQR on the card and CPU
    singles, err = {}, 0.0
    for name, mod in mods.items():
        for dtype in (f32, f64):     # float32 first: singles[name] holds it
            kind = str(dtype).replace("torch.", "")
            walls = []
            for _ in range(2):
                opt = user_solver(mod, dtype, dev)
                if opt.route != "ilqr_generic":
                    raise AssertionError(f"{name}: route {opt.route}")
                state = {k: np.array(v) for k, v in opt._inputs().items()}
                params = dict(opt.params._values)
                n0 = ig.by_problem.get(opt.problem.name, 0)
                t0 = time.perf_counter()
                opt.update()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
                if ig.by_problem[opt.problem.name] != n0 + 1:
                    raise AssertionError(f"{name}: not one launch an update")
            spec = ig.spec_of(opt.problem, opt._kinds)
            H, T, it = opt.horizon_max, opt.horizon, opt.max_iterations
            integ, n_ref = opt.integrator_type, ig.n_ref_of(spec, params)
            run = (H, n_ref, T, it, 1, integ)
            buf = torch.from_numpy(ig.pack_inputs(spec, state, params, 0,
                                                  dtype)).to(dev)
            out = ig.update(spec, buf, *run)
            got = ig.unpack_outputs(spec, out.double().cpu().numpy(), H)
            if not (np.array_equal(got["x"], opt._x)
                    and np.array_equal(got["u"], opt._u)):
                raise AssertionError(f"{name}: the solver's launch and the "
                                     "wrapper's part")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref = ig.update_reference(spec, buf, *run)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            plain = ig.unpack_outputs(spec, ref.double().cpu().numpy(), H)
            cpu = user_solver(mod, dtype, "cpu")
            t0 = time.perf_counter()
            cpu.update()
            cpu_ms = (time.perf_counter() - t0) * 1e3
            x_tol, c_tol, same = user_tolerance(name, dtype)
            print(f"{name} {kind} H={T} of {H}, up to {it} iterations: "
                  f"the traced kernel ({got['iterations']} iterations, cost "
                  f"{got['traj_costs']:.6f})")
            d = user_check("against its plain iLQR on the card", got, plain,
                           dtype, same, (x_tol, c_tol))
            user_check("against its plain iLQR on the CPU", got, dict(
                x=cpu._x, u=cpu._u, traj_costs=cpu.traj_costs,
                iterations=cpu.iterations, mu_step=cpu._mu_step), dtype,
                same, (x_tol, c_tol))
            if dtype == f64:
                err = max(err, d)
                singles[name]["float64"] = dict(
                    err_plain=d, plain_ms=plain_ms, cpu_ms=cpu_ms,
                    iterations=got["iterations"])
                continue
            n_sh = ig._size(ig.shared_layout(spec, H, n_ref))
            bare, wrap = launcher_times(
                f"ilqr_generic traced {name}", f"{kind} H={T}",
                ig.bare(spec, buf[:n_sh], buf[n_sh:].reshape(1, -1),
                        *run[:5], integrator=integ),
                lambda: ig.update(spec, buf, *run), 10)
            its = got["iterations"]
            bound = ig.bound_ms(spec, H, n_ref, T, its, integrator=integ,
                                dtype=dtype)
            chain = ig.chain_ms(spec, H, T, its, cycles, mhz, integ, dtype)
            pout, prof = ig.profile(spec, buf, *run)
            if not torch.equal(pout, out):
                raise AssertionError(f"{name}: the profiling instantiation "
                                     "parts")
            phases = phase_line(f"ilqr_generic traced {name}", f"{kind}",
                                ilqr, prof, its, mhz)
            singles[name] = dict(
                ms=bare, wrapper_ms=wrap, plain_ms=plain_ms, cpu_ms=cpu_ms,
                solve_wall_ms=walls, bound=bound, chain=chain,
                iterations=its, horizon=T, phases=phases, dtype=kind,
                err_plain=d, split=ig.split(spec, H, n_ref, dtype))
            print(f"{name} traced kernel {kind}: ms bare {bare:.4f}, wrapper "
                  f"{wrap:.4f}; Solver.update wall {walls[0]:.1f} (first, "
                  f"the library loaded) then {walls[1]:.1f}; plain on the "
                  f"card {plain_ms:.1f}, plain on the CPU {cpu_ms:.1f}; "
                  f"bound_ms {bound[0]:.6f} ({bound[1]}), chain_ms "
                  f"{chain:.4f} ({its} iterations)")

    # the crane's batch, float64
    crane = mods["crane_2d"]
    prob, _ = crane.make_problem()
    opt = crane.make_solver(device=dev)
    state = {k: np.array(v) for k, v in opt._inputs().items()}
    H, T, it = opt.horizon_max, opt.horizon, opt.max_iterations
    integ = opt.integrator_type
    t = lambda a, d=dev: torch.as_tensor(np.asarray(a, np.float64),
                                         device=d)
    tp = {k: t(v) for k, v in opt.params._values.items()}
    cfg = dict(u_min=t(state["u_lims"][..., 0]),
               u_max=t(state["u_lims"][..., 1]),
               barrier_weight=t(state["bw_lim"][:, 0]),
               lg_mult_limit=t(state["bw_lim"][:, 1]),
               dt=t(state["cfg_f"][0]),
               min_rel_cost_change=t(state["cfg_f"][1]), T=T,
               max_iterations=it, max_lg_iterations=1)
    spec = ig.spec_of(prob, trace.kinds_of_params(tp))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    batches = {}
    for B in USER_BATCHES:
        rng = np.random.default_rng(B)
        x, u, lam_, mu = batched.init_batch(prob, H, B, f64, dev)
        x0 = t(rng.normal(0.0, 1.0, (4, B)) * np.array(
            [[2.0], [0.5], [0.1], [0.1]]))
        upd = batched.make_batched_update_fn(prob, H, B, integ, f64)
        n0 = ig.launches
        got = upd(x, u, lam_, mu, x0, tp, cfg, iterations=True)
        torch.cuda.synchronize()
        if ig.launches != n0 + 1:
            raise AssertionError(f"crane batch B={B}: {ig.launches - n0} "
                                 "launches")
        shared, rows = ig.pack_inputs_batched(spec, x, u, lam_, mu, x0, tp,
                                              cfg)
        out = ig.launch(spec, shared, rows, H, 0, T, it, 1, integ)
        singles_in = ig.rows_of_batch(shared, rows)
        for b in range(B):
            one = ig.update(spec, singles_in[b].contiguous(), H, 0, T, it, 1,
                            integ)
            if not torch.equal(one, out[b]):
                raise AssertionError(f"crane batch B={B}: scenario {b} "
                                     "parts from its single launch")
        pick = [0, 1, B // 2, B - 1]
        cpu = lambda a: a[..., pick].cpu()
        ref = batched.make_batched_update_fn(prob, H, len(pick), integ,
                                             f64).reference
        want = ref(cpu(x), cpu(u), cpu(lam_), cpu(mu), cpu(x0),
                   {k: v.cpu() for k, v in tp.items()},
                   {k: (v.cpu() if torch.is_tensor(v) else v)
                    for k, v in cfg.items()}, iterations=True)
        d = max(float((g[..., pick].cpu() - w).abs().max())
                for g, w in zip(got[:3], want[:3]))
        scale = max(1.0, float(want[0].abs().max()))
        if not (d <= GENERIC_TOL * scale
                and torch.equal(got[3][pick].cpu(), want[3].to(got[3].dtype))
                and torch.equal(got[5][pick].cpu(), want[5])):
            raise AssertionError(f"crane batch B={B}: scenarios {pick} part "
                                 f"from update.reference on the CPU by {d}")
        plain_ms, line = None, ""
        if B <= 64:
            t0 = time.perf_counter()
            want = upd.reference(x, u, lam_, mu, x0, tp, cfg,
                                 iterations=True)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            d_all = max(float((g - w).abs().max())
                        for g, w in zip(got[:3], want[:3]))
            if not (d_all <= GENERIC_TOL * max(1.0, float(
                    want[0].abs().max())) and torch.equal(got[5], want[5])):
                raise AssertionError(f"crane batch B={B}: the batch and the "
                                     f"plain batched update part by {d_all}")
            d = max(d, d_all)
            line = (f", every scenario within {d_all:.3e} of the plain "
                    f"batched update on the card ({plain_ms:.1f} ms)")
        its = got[5].cpu().numpy()
        geo = ig.geometry(spec, B, H, 0, f64)
        bare, wrap = launcher_times(
            "ilqr_generic batch traced crane_2d", f"B={B}",
            ig.bare(spec, shared, rows, H, 0, T, it, integrator=integ),
            lambda: upd(x, u, lam_, mu, x0, tp, cfg), 5)
        bound = ig.bound_ms(spec, H, 0, T, its, integrator=integ)
        chain = ig.chain_ms(spec, H, T, int(its.max()), cycles, mhz, integ)
        resident = sms * geo["per_sm"] * geo["slots"]
        floor = (ig.design_floor_ms(spec, H, T, its, its, cycles, mhz,
                                    resident, integ)
                 if geo["resident"] else None)
        batches[B] = dict(ms=bare, wrapper_ms=wrap, plain_ms=plain_ms,
                          bound=bound, chain=chain,
                          floor=floor, solves_per_s=B / wrap * 1e3,
                          kernel_solves_per_s=B / bare * 1e3, geometry=geo,
                          iterations_max=int(its.max()), err=d)
        err = max(err, d)
        print(f"ilqr_generic batch traced crane_2d B={B} (float64): every "
              f"scenario bit-equal to its single launch, scenarios {pick} "
              f"within {d:.3e} of update.reference on the CPU{line}; "
              f"iterations "
              f"{int(its.min())}-{int(its.max())}; "
              f"{'resident warps' if geo['resident'] else 'a block a scenario'}"
              f" ({geo['slots']} a block, {geo['per_sm']} blocks an SM); ms "
              f"bare {bare:.4f}, wrapper {wrap:.4f}, {B / wrap * 1e3:.0f} "
              f"solves/s; bound_ms {bound[0]:.6f} ({bound[1]}), chain_ms "
              f"{chain:.4f}"
              + (f", this design's floor {floor:.4f}" if floor else ""))

    # the traced tracking MPC against its hand-written struct and kernel
    tprob, tpspec = problems.trajectory_tracking_mpc()
    tspec = trace.spec(tprob, trace.kinds_of_spec(tpspec))   # not NATIVE
    native = ig.NATIVE["trajectory_tracking_mpc"]
    H, n_ref, it, integ = MPC_H, 128, 8, ilqr.HEUN
    tracking = {}
    for warm in (False, True):
        inputs, params, mu = scenes.genopt_mpc_case(warm, 5 + warm, H)
        run = (H, n_ref, H, it, 1, integ)
        bufs = {s.name if s is native else "traced": torch.from_numpy(
            ig.pack_inputs(s, inputs, params, mu)).to(dev)
            for s in (tspec, native)}
        got = ig.unpack_outputs(tspec, ig.update(tspec, bufs["traced"], *run)
                                .cpu().numpy(), H)
        nat = ig.unpack_outputs(native, ig.update(
            native, bufs[native.name], *run).cpu().numpy(), H)
        own = itm.solve(inputs, params, H, it, 1, mu, integ, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ig.update_reference(tspec, bufs["traced"], *run)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        what = f"traced trajectory_tracking_mpc H={H} " + (
            "warm" if warm else "cold")
        print(f"{what} (float64, HEUN, {it} iterations):")
        d = user_check("against the hand-written struct (ilqr_generic)",
                       got, nat, f64, True, (GENERIC_TOL, GENERIC_TOL))
        d_own = user_check("against csrc/ilqr_tracking_mpc.cu", got, own,
                           f64, False, (GENOPT_X_ATOL, GENOPT_COST_RTOL))
        err = max(err, d, d_own)
        n_sh = {k: ig._size(ig.shared_layout(s, H, n_ref))
                for k, s in (("traced", tspec), (native.name, native))}
        launch = {k: ig.bare(s, bufs[k][:n_sh[k]],
                             bufs[k][n_sh[k]:].reshape(1, -1), *run[:5],
                             integrator=integ)
                  for k, s in (("traced", tspec), (native.name, native))}

        def checked(fn):
            def call():
                if fn():
                    raise RuntimeError("ilqr_generic launch failed")
            return call
        (a, b), (c, e) = in_turns(checked(launch[native.name]),
                                  checked(launch["traced"]), 20)
        own_ms = cuda_ms(lambda: itm.solve(inputs, params, H, it, 1, mu,
                                           integ, dev), 10)
        tracking["warm" if warm else "cold"] = dict(
            traced_ms=(c + e) / 2, native_ms=(a + b) / 2, own_solve_ms=own_ms,
            plain_ms=plain_ms, err_native=d, err_own=d_own,
            iterations=got["iterations"],
            bound=ig.bound_ms(tspec, H, n_ref, H, got["iterations"],
                              integrator=integ),
            chain=ig.chain_ms(tspec, H, H, got["iterations"], cycles, mhz,
                              integ))
        print(f"  ms by CUDA events: hand-written struct {a:.4f}, traced "
              f"{c:.4f}, traced {e:.4f}, hand-written {b:.4f}; "
              f"ilqr_tracking_mpc.solve (its wrapper, the upload and "
              f"download included) {own_ms:.4f}; the plain iLQR on the "
              f"card {plain_ms:.1f}")
    return dict(err=err, main_launches=main_launches, main_ms=main_ms,
                singles=singles, batches=batches, tracking=tracking,
                figures=figures, build_s=user_build["s"])


def build_traced_ops_sources(result):
    """Traces the two problems of ``scenes.USER_PROBLEMS`` (their captured
    tensors on the card) and builds their structs' sources in float32 and
    float64 in one ``build_generated`` call, one ``nvcc`` each, all started
    together; the seconds into result["s"], the specs into
    result["specs"], or the exception into result["error"]."""
    import torch
    from tpl_tpu_torch import scenes
    from tpl_tpu_torch.optim import ilqr_generic as ig
    from tpl_tpu_torch.optim import trace

    t0 = time.perf_counter()
    try:
        jobs = []
        for name in scenes.USER_PROBLEMS:
            for dtype in (torch.float32, torch.float64):
                prob, pspec = scenes.user_problem(name, dtype, "cuda")
                jobs.append((trace.spec(prob, trace.kinds_of_spec(pspec)),
                             dtype))
        result["trace_s"] = time.perf_counter() - t0
        ig.build_generated([s for s, _ in jobs], [d for _, d in jobs])
        result["specs"] = jobs
        result["s"] = time.perf_counter() - t0
    except Exception as e:      # raised again by the phase that needs it
        result["error"] = e


def _parting(got, want):
    """(max |dx|, |du| over the largest |x| of ``want``, relative cost
    difference) of two solves."""
    d = max(float(np.max(np.abs(np.asarray(got[k]) - np.asarray(want[k]))))
            for k in ("x", "u"))
    return (d / max(1.0, float(np.max(np.abs(want["x"])))),
            abs(got["traj_costs"] - want["traj_costs"])
            / max(abs(want["traj_costs"]), 1e-30))


def traced_ops_single(ig, name, dtype, dev, cycles, mhz, plain64=None):
    """One problem of ``scenes.USER_PROBLEMS`` solved by its ``Solver`` on
    the card at its own iterations (USER_SETTINGS it; the main path: the
    launch counts set to 0 just before, read just after: one
    ``ilqr_generic`` launch), timed through the bare launcher and the
    wrapper, against its plain iLQR on the card, equal iterations and
    mu_step: in float64 at its own iterations within USER_OWN_TOL and over
    it_exact iterations within USER_OPS_TOL; in float32 over it_f32
    iterations within USER_F32_TOL, and its own solve, the control, against
    the plain float64 one (``plain64``, the float64 call's) beyond
    USER_OWN_TOL.  Returns its figures (the float64 call's with its plain
    own solve, "plain_own")."""
    import torch
    from tpl_tpu_torch import scenes

    st = scenes.USER_SETTINGS[name]
    f64 = dtype == torch.float64
    kind = str(dtype).replace("torch.", "")
    opt = scenes.user_solver(name, dtype, dev)
    if opt.route != "ilqr_generic":
        raise AssertionError(f"{name}: route {opt.route}")
    state = {k: np.array(v) for k, v in opt._inputs().items()}
    params = dict(opt.params._values)
    ig.by_problem[name] = 0
    t0 = time.perf_counter()
    opt.update()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    launches = ig.by_problem[name]
    if launches != 1:
        raise AssertionError(f"{name}: {launches} generic launches for one "
                             "update")
    spec = ig.spec_of(opt.problem, opt._kinds)
    H, T, integ, its = (opt.horizon_max, opt.horizon, opt.integrator_type,
                        opt.max_iterations)
    n_ref = ig.n_ref_of(spec, params)
    buf = torch.from_numpy(ig.pack_inputs(spec, state, params, 0,
                                          dtype)).to(dev)

    def solve(it, plain=False):
        fn = ig.update_reference if plain else ig.update
        t0 = time.perf_counter()
        out = fn(spec, buf, H, n_ref, T, it, 1, integ)
        torch.cuda.synchronize()
        return (ig.unpack_outputs(spec, out.double().cpu().numpy(), H),
                (time.perf_counter() - t0) * 1e3)

    got, _ = solve(its)
    if not (np.array_equal(got["x"], opt._x)
            and np.array_equal(got["u"], opt._u)):
        raise AssertionError(f"{name}: the solver's launch and the "
                             "wrapper's part")
    plain, plain_ms = solve(its, True)
    print(f"{name} {kind} H={T}, its own {its} iterations: the traced kernel "
          f"({got['iterations']} taken, cost {got['traj_costs']:.9g}), "
          f"Solver.update wall {wall:.1f} ms, one ilqr_generic launch")
    out = {}
    if f64:
        tol = USER_OWN_TOL[name]
        err = user_check("against its plain iLQR on the card", got, plain,
                         dtype, True, (tol, tol))
        it_x = st["it_exact"]
        out["err_exact"] = user_check(
            f"over {it_x} iterations against its plain iLQR on the card",
            solve(it_x)[0], solve(it_x, True)[0], dtype, True,
            (USER_OPS_TOL, USER_OPS_TOL))
        out["plain_own"] = plain
    else:
        it_x = st["it_f32"]
        err = user_check(
            f"over {it_x} iterations against its plain iLQR on the card",
            solve(it_x)[0], solve(it_x, True)[0], dtype, True,
            (USER_F32_TOL, USER_F32_TOL))
        control = _parting(got, plain64)
        print(f"  the control, its own solve against the plain float64 one: "
              f"max|dx|,|du| {control[0]:.3e} of the largest |x|, cost rel "
              f"{control[1]:.3e} (must part beyond USER_OWN_TOL "
              f"{USER_OWN_TOL[name]:g})")
        if not min(control) > USER_OWN_TOL[name]:
            raise AssertionError(f"{name}: the float32 control is within "
                                 "the float64 tolerance")
        out["control"] = control
    n_sh = ig._size(ig.shared_layout(spec, H, n_ref))
    run = (H, n_ref, T, its, 1, integ)
    bare, wrap = launcher_times(
        f"ilqr_generic traced {name}", f"{kind} H={T}, {its} iterations",
        ig.bare(spec, buf[:n_sh], buf[n_sh:].reshape(1, -1), *run[:5],
                integrator=integ),
        lambda: ig.update(spec, buf, *run), 10)
    bound = ig.bound_ms(spec, H, n_ref, T, got["iterations"],
                        integrator=integ, dtype=dtype)
    chain = ig.chain_ms(spec, H, T, got["iterations"], cycles, mhz, integ,
                        dtype)
    regs, local, _ = ig.attributes(spec, dtype)
    print(f"{name} traced kernel {kind}: ms bare {bare:.4f}, wrapper "
          f"{wrap:.4f}; plain on the card {plain_ms:.1f}; bound_ms "
          f"{bound[0]:.6f} ({bound[1]}), chain_ms {chain:.4f}; {regs} "
          f"registers, {local} B local; {len(spec.consts)} constant table "
          "words")
    out.update(ms=bare, wrapper_ms=wrap, plain_ms=plain_ms, wall_ms=wall,
               launches=launches, err=err, bound=bound, chain=chain,
               iterations=got["iterations"], max_iterations=its, horizon=T,
               registers=regs, local_bytes=local, dtype=kind,
               consts=len(spec.consts))
    return out


def traced_ops_batch(ig, name, B, dev, cycles, mhz):
    """The batch of one problem of ``scenes.USER_PROBLEMS`` through
    ``optim.batched`` on CUDA tensors, float64, at its own iterations (the
    main path: one launch), finite and timed, with the bounds and the
    design floor; over it_exact iterations every scenario bit-equal to its
    single launch and four within USER_OPS_TOL of ``update.reference`` on
    the CPU (the problem's captured tensors there); at B <= 64 every
    scenario against the plain batched update on the card, within
    USER_OPS_TOL over it_exact iterations and within USER_OWN_TOL over
    USER_OWN_BATCH_IT, equal iterations."""
    import torch
    from tpl_tpu_torch import scenes
    from tpl_tpu_torch.optim import batched, trace

    f64 = torch.float64
    st = scenes.USER_SETTINGS[name]
    H, integ = st["H"], st["integ"]
    prob, pspec = scenes.user_problem(name, f64, dev)
    cpu_prob, _ = scenes.user_problem(name, f64, "cpu")
    t = lambda a, d=dev: torch.as_tensor(np.asarray(a, np.float64),
                                         device=d)
    tp = {k: t(v) for k, v in pspec.items()}
    lims = np.asarray(st["u_lim"], float)

    def cfg(it):
        return dict(u_min=t(np.tile(lims[:, 0], (H, 1))),
                    u_max=t(np.tile(lims[:, 1], (H, 1))),
                    barrier_weight=t(np.ones(prob.nc)),
                    lg_mult_limit=t(np.full(prob.nc, 1e4)), dt=t(st["dt"]),
                    min_rel_cost_change=t(1e-6), T=H, max_iterations=it,
                    max_lg_iterations=1)
    spec = ig.spec_of(prob, trace.kinds_of_params(tp))
    rng = np.random.default_rng(B)
    x, u, lam_, mu = batched.init_batch(prob, H, B, f64, dev)
    x0 = t(np.asarray(st["x0"])[:, None] + rng.normal(0.0, 1.0, (4, B))
           * np.array([[0.5], [0.5], [0.05], [0.5]]))
    args = (x, u, lam_, mu, x0, tp)
    upd = batched.make_batched_update_fn(prob, H, B, integ, f64)
    it = st["it"]
    n0 = ig.launches
    got = upd(*args, cfg(it), iterations=True)
    torch.cuda.synchronize()
    if ig.launches != n0 + 1:
        raise AssertionError(f"{name} batch B={B}: {ig.launches - n0} "
                             "launches")
    if not all(bool(torch.isfinite(g).all()) for g in got[:3]):
        raise AssertionError(f"{name} batch B={B}: not finite")

    # over it_exact iterations: bit-equal to the single launches, and four
    # scenarios against update.reference on the CPU
    it_x = st["it_exact"]
    exact = upd(*args, cfg(it_x), iterations=True)
    shared, rows = ig.pack_inputs_batched(spec, *args, cfg(it_x))
    out = ig.launch(spec, shared, rows, H, 0, H, it_x, 1, integ)
    singles = ig.rows_of_batch(shared, rows)
    for b in range(B):
        one = ig.update(spec, singles[b].contiguous(), H, 0, H, it_x, 1,
                        integ)
        if not torch.equal(one, out[b]):
            raise AssertionError(f"{name} batch B={B}: scenario {b} parts "
                                 "from its single launch")
    pick = [0, 1, B // 2, B - 1]
    cpu = lambda a: a[..., pick].cpu()
    ref = batched.make_batched_update_fn(cpu_prob, H, len(pick), integ,
                                         f64).reference
    want = ref(*(cpu(a) for a in args[:5]),
               {k: v.cpu() for k, v in tp.items()},
               {k: (v.cpu() if torch.is_tensor(v) else v)
                for k, v in cfg(it_x).items()}, iterations=True)
    scale = max(1.0, float(want[0].abs().max()))
    d = max(float((g[..., pick].cpu() - w).abs().max())
            for g, w in zip(exact[:3], want[:3]))
    if not (d <= USER_OPS_TOL * scale
            and torch.equal(exact[3][pick].cpu(), want[3].to(exact[3].dtype))
            and torch.equal(exact[5][pick].cpu(), want[5])):
        raise AssertionError(f"{name} batch B={B}: scenarios {pick} part "
                             f"from update.reference on the CPU by {d}")
    line = (f"over {it_x} iterations every scenario bit-equal to its single "
            f"launch, scenarios {pick} within {d:.3e} of update.reference "
            "on the CPU")

    def against_plain(it, res, tol):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = upd.reference(*args, cfg(it), iterations=True)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        d = max(float((g - w).abs().max()) for g, w in zip(res[:3], want[:3]))
        d /= max(1.0, float(want[0].abs().max()))
        if not (d <= tol and torch.equal(res[5], want[5])):
            raise AssertionError(f"{name} batch B={B}: over {it} iterations "
                                 f"the batch and the plain batched update "
                                 f"part by {d:.3e} of the largest |x| "
                                 f"(tolerance {tol:g}), iterations equal: "
                                 f"{torch.equal(res[5], want[5])}")
        return d, ms

    plain_ms, err = None, None
    if B <= 64:
        d_x, _ = against_plain(it_x, exact, USER_OPS_TOL)
        it_c = USER_OWN_BATCH_IT[name]
        err, plain_ms = against_plain(it_c, got if it_c == it else upd(
            *args, cfg(it_c), iterations=True), USER_OWN_TOL[name])
        if it_c != it:
            t0 = time.perf_counter()
            upd.reference(*args, cfg(it))
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
        line += (f"; every scenario against the plain batched update on the "
                 f"card: {d_x:.3e} over {it_x} iterations, {err:.3e} over "
                 f"{it_c} (tolerance {USER_OWN_TOL[name]:g}), its own "
                 f"{it} iterations there {plain_ms:.1f} ms")
    its = got[5].cpu().numpy()
    geo = ig.geometry(spec, B, H, 0, f64)
    shared, rows = ig.pack_inputs_batched(spec, *args, cfg(it))
    bare, wrap = launcher_times(
        f"ilqr_generic batch traced {name}", f"B={B}, {it} iterations",
        ig.bare(spec, shared, rows, H, 0, H, it, integrator=integ),
        lambda: upd(*args, cfg(it)), 5)
    bound = ig.bound_ms(spec, H, 0, H, its, integrator=integ)
    chain = ig.chain_ms(spec, H, H, int(its.max()), cycles, mhz, integ)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    floor = (ig.design_floor_ms(spec, H, H, its, its, cycles, mhz,
                                sms * geo["per_sm"] * geo["slots"], integ)
             if geo["resident"] else None)
    print(f"ilqr_generic batch traced {name} B={B} (float64), its own {it} "
          f"iterations ({int(its.min())}-{int(its.max())} taken): {line}; "
          f"{'resident warps' if geo['resident'] else 'a block a scenario'}"
          f" ({geo['slots']} a block, {geo['per_sm']} blocks an SM); ms bare "
          f"{bare:.4f}, wrapper {wrap:.4f}, {B / wrap * 1e3:.0f} solves/s; "
          f"bound_ms {bound[0]:.6f} ({bound[1]}), chain_ms {chain:.4f}"
          + (f", this design's floor {floor:.4f}" if floor else ""))
    return dict(ms=bare, wrapper_ms=wrap, plain_ms=plain_ms, bound=bound,
                chain=chain, floor=floor, solves_per_s=B / wrap * 1e3,
                geometry=geo, iterations_max=int(its.max()),
                err=err if err is not None else d, err_exact=d)


def traced_ops_phase(ig, dev, cycles, mhz, ops_build):
    """What the tracer takes beyond the arithmetic, on the card: the two
    problems of ``scenes.USER_PROBLEMS`` (the quadratic tracking MPC with
    its captured weights and reference read by the step index, H = 100;
    the vehicle on the captured 200 x 200 cost map through ``blerp``,
    H = 80), traced into the generic kernel's struct and built by
    ``build_traced_ops_sources`` beside the first phases.  Each single at
    its own iterations, in float64 and float32, through its ``Solver``
    (``traced_ops_single``), and the float64 batch at USER_BATCHES
    (``traced_ops_batch``)."""
    import torch
    from tpl_tpu_torch import scenes

    ops_build["thread"].join()
    if "error" in ops_build:
        raise ops_build["error"]
    print(f"traced operations: traced in {ops_build['trace_s']:.2f} s; "
          f"{len(ops_build['specs'])} sources (nvcc, one each, started "
          f"together beside the first phases) built in "
          f"{ops_build['s']:.2f} s")
    figures = generic_build_figures(
        ig, [(f"traced {s.name}", s, d) for s, d in ops_build["specs"]])
    out = {}
    for name in scenes.USER_PROBLEMS:
        s64 = traced_ops_single(ig, name, torch.float64, dev, cycles, mhz)
        s32 = traced_ops_single(ig, name, torch.float32, dev, cycles, mhz,
                                s64.pop("plain_own"))
        out[name] = dict(
            float64=s64, float32=s32,
            batches={B: traced_ops_batch(ig, name, B, dev, cycles, mhz)
                     for B in USER_BATCHES})
    return dict(problems=out, figures=figures, build_s=ops_build["s"])


def demo_legs_phase():
    """``tplsim run --headless --no-reload --seed 0`` on each of
    DEMO_SCENARIOS for DEMO_TICKS ticks on the card, as child processes
    run side by side to their ends, with the scenario's own sets (the RSTP
    planner fused, H = 250, and its collision screen as the set has it;
    the spatial MPC, H = 60): each leg's exit code (0 with no violation),
    rule violations and emergency ticks equal to the JAX package's own CPU
    loop over the same ticks (DEMO_JAX_END, tests/jax_demo_loops.py), the
    ego's end position and speed within DEMO_END_ATOL of it."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    t0 = time.perf_counter()
    procs = {}
    try:
        for scenario in DEMO_SCENARIOS:
            procs[scenario] = subprocess.Popen(
                [sys.executable, "-m", "tpl_tpu_torch.simulation.tplsim",
                 "run", "--scenario", scenario, "--headless", "--no-reload",
                 "--seed", "0", "--max-ticks", str(DEMO_TICKS)],
                cwd=root, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)
        outs = {s: p.communicate(timeout=600) for s, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    legs = {}
    for scenario, (stdout, stderr) in outs.items():
        code = procs[scenario].returncode
        ego = re.search(r"ego: x=(\S+) y=(\S+) v=(\S+); emergency ticks: "
                        r"(\d+)", stdout)
        viol = re.search(r"rule violations: (\d+)", stdout)
        if ego is None or viol is None or f"ticks={DEMO_TICKS}" not in stdout:
            raise AssertionError(f"tplsim run {scenario} (exit code {code})"
                                 f":\n{stdout[-2000:]}\n{stderr[-3000:]}")
        x, y, v = (float(ego.group(i)) for i in (1, 2, 3))
        emergency, n_viol = int(ego.group(4)), int(viol.group(1))
        jt, jx, jy, jv, j_viol, j_emergency = DEMO_JAX_END[scenario]
        d = max(abs(x - jx), abs(y - jy), abs(v - jv))
        print(f"tplsim run {scenario}: exit code {code}, {n_viol} violations"
              f", {emergency} emergency ticks, ego x {x:.4f} y {y:.4f} v "
              f"{v:.4f}; the JAX package's CPU loop: {j_viol} violations, "
              f"{j_emergency} emergency ticks, x {jx:.4f} y {jy:.4f} v "
              f"{jv:.4f} (max difference {d:.4f})")
        if (code != (1 if j_viol else 0) or n_viol != j_viol
                or emergency != j_emergency or not d <= DEMO_END_ATOL):
            raise AssertionError(f"tplsim run {scenario}: beyond the JAX "
                                 f"loop's end:\n{stdout[-2000:]}")
        legs[scenario] = dict(code=code, violations=n_viol,
                              emergency=emergency, end=(x, y, v), diff=d)
    print(f"demo legs: {len(legs)} tplsim runs side by side in {wall:.1f} s")
    return legs


def slice_batch_chain(lam, solve, ins, tables, B, what, plain=None):
    """Every backward slice of a batch of B on the card, chained through
    the plain version on the CPU where ``plain`` (the CPU solver, inputs
    and tables) is given, else through the batched kernel itself: each slice
    one launch by the wrapper's counters, bit-equal to the plain version
    (NaN equal to NaN) where given and every scenario to its one-scenario
    launch.  Returns the first slice's inputs on the card and the nodes
    with a NaN."""
    import torch

    T, S = DEMO_SPEC["t_steps"], DEMO_SPEC["s_steps"]
    dist_g, rls_g, step_g, pps_g = ins
    if plain is not None:
        solve_c, (dist_c, rls_c, step_c, pps_c), tables_c = plain
        nxt = torch.stack([solve_c.final_slice(
            dist_c[b], rls_c[b], step_c, pps_c[b]) for b in range(B)])
    else:
        nxt = torch.stack([solve.final_slice(
            dist_g[b], rls_g[b], step_g, pps_g[b]) for b in range(B)])
    n_nan, first = 0, None
    for i in range(T - 2, 0, -1):
        nxt_g = nxt.to(dist_g.device)
        before = lam.launches, lam.slice_launches, lam.batch_launches
        got = solve.backward_slice_batch(nxt_g, i, dist_g, rls_g, step_g,
                                         pps_g, tables)
        torch.cuda.synchronize()
        if (lam.launches, lam.slice_launches, lam.batch_launches) != (
                before[0] + 1, before[1] + (B == 1), before[2] + (B > 1)):
            raise AssertionError("the batched slice: not one launch of the "
                                 "instantiation for its B")
        if plain is not None:
            want = solve_c.backward_slice_batch_reference(
                nxt, i, dist_c, rls_c, step_c, pps_c, tables_c)
            np.testing.assert_array_equal(
                got.cpu().numpy(), want.numpy(),
                err_msg=f"batched slice B={B} slice {i} against the plain "
                "version")
        for b in range(B):
            single = lam.backward_slice_launch(
                nxt_g[b:b + 1], dist_g[b:b + 1, i], rls_g[b:b + 1], step_g,
                i, tables.tables[b])[0]
            if not nan_equal(single, got[b]):
                raise AssertionError(f"batched slice B={B} slice {i} "
                                     f"scenario {b}: not its one-scenario "
                                     "launch's bits")
        n_nan += int(torch.isnan(got).any(-1).sum())
        if first is None:
            first = (nxt_g, dist_g, rls_g, step_g, pps_g, tables, i)
        nxt = want if plain is not None else got
    if not n_nan:
        raise AssertionError("the NaN distance cells reached no node")
    print(f"batched slice B={B} at S={S} DS={DEMO_SPEC['ds_steps']} "
          f"L={DEMO_SPEC['l_steps']}: all {T - 2} slices bit-equal to {what} "
          f"and every scenario to its one-scenario launch; nodes with a NaN "
          f"{n_nan}")
    return first


def slice_lib(lam, csrc):
    """The fused slice's library: the tree's (``csrc`` None, bound by the
    wrapper) or another version's built from ``csrc``, with the argument
    types of its slice entry and, where it exports one, of its profiling
    entry."""
    from tpl_tpu_torch import _build

    if csrc is None:
        return lam._kernel()
    lib = _build.load("latlon_action_min", csrc)
    lib.latlon_backward_slice.restype = ctypes.c_int
    lib.latlon_backward_slice.argtypes = (
        lam._kernel().latlon_backward_slice.argtypes)
    if hasattr(lib, "latlon_backward_slice_profile"):
        lib.latlon_backward_slice_profile.restype = ctypes.c_int
        lib.latlon_backward_slice_profile.argtypes = (
            lam._kernel().latlon_backward_slice_profile.argtypes)
    return lib


def slice_launcher(lib, case, out, prof=None):
    """``launch(stream)`` of the fused slice entry of ``lib`` (its profiling
    entry with ``prof``) on ``case`` = (nodes_next, dist_x, ref_lines,
    ref_step, pps, tables, i) into ``out``; raises on a CUDA error."""
    nxt, dist_x, rls, step, _, tb, i = case
    dist_t = dist_x[:, i]
    B, S, DS, L, _ = nxt.shape
    ptrs = (ctypes.c_void_p * len(tb.ptrs))(*tb.ptrs)
    args = (nxt.data_ptr(), dist_t.data_ptr(), rls.data_ptr(),
            step.data_ptr(), tb.slice_consts.data_ptr(), ptrs,
            out.data_ptr(), S, DS, L, rls.shape[1], i, B, dist_t.stride(0))

    def launch(stream):
        err = (lib.latlon_backward_slice(*args, stream) if prof is None else
               lib.latlon_backward_slice_profile(*args, prof.data_ptr(),
                                                 stream))
        if err:
            raise RuntimeError(f"latlon_backward_slice: CUDA error {err}")
    return launch


def cuobjdump(*args):
    """The output of the toolkit's ``cuobjdump`` (beside ``nvcc``)."""
    from tpl_tpu_torch import _build

    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    return subprocess.run([tool, *args], capture_output=True, text=True,
                          check=True).stdout


def demangle(names):
    """The C++ names of mangled ``names`` (as given where c++filt is
    missing), shortened to the kernel and its template arguments."""
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True,
                             check=True).stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        return list(names)
    return [re.sub(r"^.*?(\w+(<[^()]*>)?)\(.*$", r"\1", n) for n in out]


SASS_LINE = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)")


def slice_kernel_report(so, phases):
    """Per fused-slice kernel of the library ``so`` (its C++ name): the
    registers and stack bytes (``cuobjdump -res-usage``), the SASS
    instruction count (``cuobjdump -sass``) and, for a kernel that reads the
    clock, the instructions between its consecutive clock reads, named by
    ``phases`` (the stamps' order in the code; the first stretch also holds
    the kernel's prologue), with the opcodes of the action loop's stretch
    by kind."""
    usage = {}
    for fn, reg, stack in re.findall(
            r"Function (\S+):\s*\n\s*REG:(\d+) STACK:(\d+)",
            cuobjdump("-res-usage", so)):
        usage[fn] = (int(reg), int(stack))
    report = {}
    for block in cuobjdump("-sass", so).split("Function : ")[1:]:
        fn = block.split(None, 1)[0]
        if "backward_slice" not in fn:
            continue
        ops, cuts = [], []
        for line in block.splitlines():
            m = SASS_LINE.search(line)
            if m:
                if "SR_CLOCK" in line:
                    cuts.append(len(ops))
                ops.append(m.group(1))
        regs, stack = usage.get(fn, (None, None))
        r = dict(registers=regs, stack_bytes=stack, instructions=len(ops))
        if len(cuts) == len(phases) + 1:
            seg = [ops[a:b] for a, b in zip(cuts, cuts[1:])]
            r["instructions_by_phase"] = {
                p: len(s) for p, s in zip(phases, seg)}
            act = seg[phases.index("actions")]
            r["action_loop_opcodes"] = {
                k: sum(o.split(".")[0] in ks for o in act)
                for k, ks in (("LDS", ("LDS",)), ("LDG", ("LDG", "LD")),
                              ("FSETP", ("FSETP",)),
                              ("SEL", ("SEL", "FSEL")),
                              ("FADD", ("FADD",)), ("FMUL", ("FMUL",)),
                              ("FMNMX", ("FMNMX",)))}
        elif cuts:
            r["clock_reads"] = len(cuts)
        report[fn] = r
    return dict(zip(demangle(list(report)), report.values()))


def slice_phase_line(lam, what, cycles, items, mhz):
    """One "phases" line of the batched slice's profiling entry: thread 0's
    cycles summed over the blocks, as us a work item (s tile, ds,
    scenario) at the SM clock."""
    us = {k: c / items / mhz for k, c in zip(lam.SLICE_PHASES, cycles)}
    print(f"phases latlon_backward_slice {what} (thread 0, {items} items, SM "
          f"{mhz:.0f} MHz): us an item " + ", ".join(
              f"{k} {v:.3f}" for k, v in us.items())
          + f" (sum {sum(us.values()):.3f})")
    return us


def batch_slice_phase(lam, tllk, dev, mhz, parent_csrc=None):
    """The fused backward slice for a scenario batch (one launch) at the
    demo grid on ``scenes.dp_batch_scenes`` (per-scenario leader, parked
    car, lane bounds, ``l_trg``; one scenario with NaN distance cells):
    at B in SLICE_BATCHES every backward slice, chained through the plain
    version on the CPU, bit-equal to it (NaN equal to NaN), at B in
    SLICE_CARD_BATCHES chained through the kernel; each scenario bit-equal
    to its own one-scenario launch; one launch a slice by the wrapper's
    counter; a whole batch solve launches it T - 2 times and each
    scenario's plan is its one-scenario solve's.  Times at B in
    SLICE_BATCHES_TIMED from CUDA graphs and by events: one batched launch
    against B one-scenario launches, and with ``parent_csrc`` against that
    source's batched entry in turns (bits per scenario, which must agree);
    the one-scenario slice in turns with the parent's; the profiling entry
    (bit-equal, "phases" line) of every source that exports one; each
    source's kernels' registers, stack and SASS counts; the tree's
    ``numRegs`` / ``localSizeBytes``; the wrapper, the plain version, the
    bounds and scenarios per second of slice time."""
    import torch
    from tpl_tpu_torch import _build, scenes

    T, S, DS, L = (DEMO_SPEC[k] for k in ("t_steps", "s_steps", "ds_steps",
                                          "l_steps"))
    solves = {d: tllk.make_latlon_solver(DEMO_SPEC, d)[0]
              for d in ("cpu", dev)}
    cases = {}
    for B in SLICE_BATCHES + SLICE_CARD_BATCHES:
        on_cpu = B in SLICE_BATCHES
        dist, rl, pp, x0 = scenes.dp_batch_scenes(B, T, S, L, seed=B)
        ins = {d: solves[d].batch_inputs(dist, rl, 0.5, pp)
               for d in (solves if on_cpu else (dev,))}
        tables = {d: lam.BatchTables([solves[d].action_tables(p)
                                      for p in ins[d][3]]) for d in ins}
        plain = (solves["cpu"], ins["cpu"], tables["cpu"]) if on_cpu else None
        cases[B] = slice_batch_chain(
            lam, solves[dev], ins[dev], tables[dev], B,
            "the plain version on the CPU" if on_cpu else
            "the batched kernel's own chain", plain)

    # a whole batch solve: T - 2 launches, each plan its own solve's
    B = SLICE_BATCH_TIMED
    dist, rl, pp, x0 = scenes.dp_batch_scenes(B, T, S, L, seed=B, nan=False)
    before = lam.batch_launches, lam.slice_launches
    nodes, trajs = solves[dev].batch(dist, rl, 0.5, pp, x0)
    torch.cuda.synchronize()
    if (lam.batch_launches - before[0], lam.slice_launches - before[1]) != (
            T - 2, 0):
        raise AssertionError("a batch solve is not T - 2 batched launches")
    for b in (0, B - 1):
        n_b, tr_b = solves[dev](dist[b], rl[b], 0.5, pp[b], x0[b])
        if not (torch.equal(n_b, nodes[b]) and torch.equal(tr_b, trajs[b])):
            raise AssertionError(f"batch solve scenario {b}: another plan "
                                 "than its own solve")
    print(f"batch solve B={B}: {T - 2} batched launches, no one-scenario "
          "launch; scenarios 0 and B-1 bit-equal to their own solves")

    parents = parents_with(parent_csrc, "latlon_action_min")
    libs = {"tree": slice_lib(lam, None)}
    libs.update({csrc: slice_lib(lam, csrc) for csrc in parents
                 if slice_takes_batch(csrc)})
    res = {"times": {}, "parent_ms": {}, "phases_us": {}}
    n_tiles = -(-S // lam._kernel().latlon_action_min_tile_rows(L))
    for B in (1,) + SLICE_BATCHES_TIMED:
        case = cases[B]
        outs = {k: torch.empty_like(case[0]) for k in libs}
        run = {k: slice_launcher(lib, case, outs[k])
               for k, lib in libs.items()}
        stream = torch.cuda.current_stream(dev).cuda_stream
        for k in libs:
            run[k](stream)
        torch.cuda.synchronize()
        tree = run["tree"]
        for k in libs:
            if k == "tree":
                continue
            diff = [0.0 if nan_equal(outs[k][b], outs["tree"][b]) else float(
                (outs[k][b] - outs["tree"][b]).abs().nan_to_num(
                    float("inf")).max()) for b in range(B)]
            g = in_turns_graph(run[k], tree)
            e = in_turns(lambda: run[k](stream), lambda: tree(stream), 100)
            print(f"latlon_backward_slice B={B} vs the source in {k}: max "
                  f"|new - parent| per scenario {max(diff):.3e} (scenarios "
                  f"{B}); from CUDA graphs ms parent {g[0]:.4f}, new "
                  f"{g[1]:.4f}, new {g[2]:.4f}, parent {g[3]:.4f}; events "
                  f"parent {e[0][0]:.4f}, new {e[1][0]:.4f}, new "
                  f"{e[1][1]:.4f}, parent {e[0][1]:.4f}")
            if max(diff) != 0.0:
                raise AssertionError(f"the batched slice B={B}: another "
                                     f"result than the source in {k}")
            res["parent_ms"].setdefault(B, {})[k] = g
        for k, lib in libs.items():
            if not hasattr(lib, "latlon_backward_slice_profile") or B == 1:
                continue
            prof = torch.zeros(len(lam.SLICE_PHASES), dtype=torch.int64,
                               device=dev)
            pout = torch.empty_like(case[0])
            slice_launcher(lib, case, pout, prof)(stream)
            torch.cuda.synchronize()
            if not nan_equal(pout, outs[k]):
                raise AssertionError(f"the profiling slice of {k}: other "
                                     "bits than its plain entry")
            us = slice_phase_line(lam, f"B={B} {k}", prof.cpu().tolist(),
                                  B * DS * n_tiles, mhz)
            res["phases_us"].setdefault(B, {})[k] = us
        if B == 1:
            continue
        nxt, dist_x, rls, step, pps, tb, i = case
        single = [slice_launcher(libs["tree"], (
            nxt[b:b + 1], dist_x[b:b + 1], rls[b:b + 1], step, None,
            tb.tables[b], i), outs["tree"][b:b + 1]) for b in range(B)]

        def singles(s, single=single):
            for launch in single:
                launch(s)

        g_batch, g_single = graph_ms(tree), graph_ms(singles)
        g_batch2 = graph_ms(tree)
        e_single = cuda_ms(lambda: singles(stream), 50)
        e_batch = cuda_ms(lambda: tree(stream), 100)
        bound = lam.batch_bound_ms(B, S, DS, L)
        ms = (g_batch + g_batch2) / 2
        print(f"batched slice at B={B} S={S} DS={DS} L={L}, slice "
              f"{i}: from CUDA graphs one batched launch "
              f"{g_batch:.4f} ms (again {g_batch2:.4f}), {B} one-scenario "
              f"launches {g_single:.4f} ms; by events {e_batch:.4f} / "
              f"{e_single:.4f} ms; bound {bound[0]:.4f} ms ({bound[1]}); "
              f"{B / ms * 1e3:.0f} scenarios a second of slice time; "
              f"{lam._kernel().latlon_backward_slice_grid(S, DS, L, B)} "
              f"blocks for {B * DS * n_tiles} items")
        res["times"][B] = dict(ms=ms, single_ms=g_single, event_ms=e_batch,
                               single_event_ms=e_single, bound=bound,
                               scenarios_per_s=B / ms * 1e3)

    # the registers and spills: the tree's kernels by cudaFuncGetAttributes,
    # every source's by cuobjdump, with the SASS counts
    attrs = lam.slice_kernel_attributes()
    print("latlon_backward_slice kernels (cudaFuncGetAttributes): " + ", ".join(
        f"{k} numRegs {r} localSizeBytes {b}" for k, (r, b) in attrs.items()))
    sass = {}
    for k in libs:
        so = _build._paths("latlon_action_min", None if k == "tree" else k)[1]
        sass[k] = slice_kernel_report(so, lam.SLICE_PHASES)
        for fn, r in sass[k].items():
            print(f"sass {k} {fn}: {json.dumps(r)}")

    # the wrapper and the plain version at B = SLICE_BATCH_TIMED
    nxt, dist_x, rls, step, pps, tb, i = cases[SLICE_BATCH_TIMED]
    wrapper_ms = cuda_ms(lambda: solves[dev].backward_slice_batch(
        nxt, i, dist_x, rls, step, pps, tb), 100)
    plain_ms = cuda_ms(lambda: solves[dev].backward_slice_batch_reference(
        nxt, i, dist_x, rls, step, pps, tb), 5)
    t = res["times"][SLICE_BATCH_TIMED]
    print(f"batched slice at B={SLICE_BATCH_TIMED}: the wrapper "
          f"{wrapper_ms:.4f} ms, the plain version on the card "
          f"{plain_ms:.4f} ms")
    return dict(err=0.0, ms=t["ms"], single_ms=t["single_ms"],
                event_ms=t["event_ms"],
                single_event_ms=t["single_event_ms"], wrapper_ms=wrapper_ms,
                plain_ms=plain_ms, bound=t["bound"], times=res["times"],
                parent_ms=res["parent_ms"], phases_us=res["phases_us"],
                attributes=attrs, sass=sass)


def dryrun_phase(lam, itm, idk):
    """``tpl_tpu_torch.parallel.dryrun_multichip(device_count)`` on the
    cards at its full widths (the tracking MPC at H=60 and 8 iterations,
    the IDM sweep's 100-step rollouts, the DP batch at the vendored
    planner's 10 x 201 x 37 x 21 grid, the env build at 10 x 201 x 21): the
    launch counters set to 0 just before and read just after; every kernel
    of the path launched, the batched slice T - 2 times a mesh device.
    Run twice: the second run's wall times are warm."""
    import torch
    from tpl_tpu_torch.parallel import dryrun

    n = torch.cuda.device_count()
    lam.batch_launches = lam.slice_launches = 0
    itm.launches_batched = 0
    idk.rollout_launches = idk.evaluate_launches = 0
    first = dryrun.dryrun_multichip(n)
    counts = {"latlon_backward_slice_batched": lam.batch_launches,
              "ilqr_tracking_mpc_batched": itm.launches_batched,
              "idm_rollout": idk.rollout_launches,
              "idm_evaluate": idk.evaluate_launches}
    print("dryrun launches: " + ", ".join(f"{k} {v}"
                                           for k, v in counts.items())
          + f", one-scenario slices {lam.slice_launches}")
    if not all(counts.values()):
        raise AssertionError("a kernel of the dryrun was not launched")
    T = dryrun.LATLON_SPEC["t_steps"]
    if counts["latlon_backward_slice_batched"] != (T - 2) * n \
            or lam.slice_launches:
        raise AssertionError("the DP batch: not T - 2 batched launches a "
                             "mesh device")
    warm = dryrun.dryrun_multichip(n)
    print("dryrun wall s, first / warm: " + ", ".join(
        f"{k} {first['seconds'][k]:.3f} / {warm['seconds'][k]:.3f}"
        for k in first["seconds"]) + f" (B: MPC {dryrun.MPC_PER_DEVICE * n}, "
        f"IDM {dryrun.IDM_PER_DEVICE * n} candidates, DP "
        f"{dryrun.LATLON_PER_DEVICE * n}, env {dryrun.ENV_PER_DEVICE * n})")
    return dict(counts=counts, first=first["seconds"], warm=warm["seconds"])


def probe_phase(lat, itm, dev):
    """The card's operation latencies (csrc/latency_probe.cu) and the SM
    clock under load; prints them with the card's name and power limit."""
    import torch

    host, args = mpc_setup_inputs(itm, 20)
    buf = torch.from_numpy(host).to(dev)
    itm.update(buf, *args)
    torch.cuda.synchronize()

    def busy():
        for _ in range(400):
            itm.update(buf, *args)

    mhz = sm_clock_mhz(busy)
    runs = [lat.measure(dev) for _ in range(3)]
    torch.cuda.synchronize()
    cycles = {k: min(r[k] for r in runs) for k in lat.PROBES}
    print("latency probe on " + smi("name,power.limit")
          + f" at SM {mhz:.0f} MHz, cycles per dependent operation (least "
          "of 3 runs of 4096): "
          + json.dumps({k: round(v, 2) for k, v in cycles.items()}))
    # the tracking-MPC rollouts take sin and cos of an angle in one
    # sincos() call: its bits must be those of sin() and cos()
    spans = [(-8.0, 8.0), (-1000.0, 1000.0), (-1e-3, 1e-3)]
    bad = [lat.sincos_mismatches(dev, lo, hi, 4_000_000) for lo, hi in spans]
    print(f"sincos vs sin, cos on 4,000,000 float64 arguments in each of "
          f"{spans}: {bad} differ")
    if any(bad):
        raise AssertionError("sincos() and sin(), cos() differ on this card")
    return cycles, mhz


def _lock_timer(stats):
    """Wraps ``ShmStore.lock`` and ``ShmStore.revalidate`` of this process:
    per store file, the outermost locks' count and their round trips (the
    wait, the read, the publish and the release; not the body), and the
    reads' (``revalidate``: the wait, the read and the release), in ms."""
    from tpl_tpu_torch.util.shm_store import ShmStore

    lock, revalidate = ShmStore.lock, ShmStore.revalidate

    def add(kind, store, ms):
        s = stats.setdefault(os.path.basename(store._file_path), {}) \
            .setdefault(kind, [0, 0.0, 0.0])
        s[0] += 1
        s[1] += ms
        s[2] = max(s[2], ms)

    def timed_read(store):
        t = time.perf_counter()
        revalidate(store)
        add("reads", store, (time.perf_counter() - t) * 1e3)

    def timed(store):
        ctx = lock(store)
        outer = store._lock_depth == 0

        class Timed:
            def __enter__(self):
                t = time.perf_counter()
                out = ctx.__enter__()
                self.t = time.perf_counter()
                self.ms = (self.t - t) * 1e3
                return out

            def __exit__(self, *exc):
                t = time.perf_counter()
                try:
                    return ctx.__exit__(*exc)
                finally:
                    if outer:
                        add("locks", store, self.ms + (
                            time.perf_counter() - t) * 1e3)

        return Timed()

    ShmStore.lock = timed
    ShmStore.revalidate = timed_read


def deploy_child(app, app_id):
    """One app of the multi-process deployment in this fresh process, on
    the card: ``mains.env_main`` / ``planning_main`` / ``control_main``
    under ``app_id``, its kernel libraries bound first (built by the
    parent).  SIGTERM ends it (``mains.exit_on_sigterm``); it then prints
    one JSON line: the kernel launches, the updates (planning: by the
    planner that ran, with the DP replans and the RSTP planner's
    ``write_debug_data`` values seen; control: the MPC solves), the wall
    and each store's lock round trips."""
    import torch
    import tpl_tpu_torch
    from tpl_tpu_torch.application import mains
    from tpl_tpu_torch.optim import ilqr_rstp as rstp
    from tpl_tpu_torch.optim import ilqr_tracking_mpc as itm
    from tpl_tpu_torch.planning.dyn_prog import latlon_action_min as lam
    from tpl_tpu_torch.planning.path_vel_decomp import rstp_rampify as rmp

    tpl_tpu_torch.use_device("cuda")
    mains.exit_on_sigterm()
    for mod in {"planning": (rstp, rmp, lam), "control": (itm,)}.get(app, ()):
        mod._kernel()

    def counts():
        return {"ilqr_rstp": rstp.launches, "rstp_rampify": rmp.launches,
                "latlon_backward_slice": lam.slice_launches,
                "latlon_action_min": lam.launches,
                "ilqr_tracking_mpc": itm.launches}

    out = {"app": app, "locks": {}, "by_planner": {}}
    _lock_timer(out["locks"])
    if app == "planning":
        from tpl_tpu_torch.application.planning_app import PlanningApp
        update = PlanningApp.update

        def counted(self):
            dp = self.planners[DEPLOY_SWITCH]
            last = dp.policy.last_replan_time
            before = counts()
            update(self)
            after = counts()
            now = time.perf_counter()
            rec = out["by_planner"].setdefault(self.last_active_planner, {
                "updates": 0, "dp_replans": 0, "write_debug_data": [],
                "launches": dict.fromkeys(before, 0), "first": now})
            rec["updates"] += 1
            rec["last"] = now
            rec["dp_replans"] += dp.policy.last_replan_time != last
            for k in before:
                rec["launches"][k] += after[k] - before[k]
            # the bundle the planner holds, as the app's last lock left it
            seen = self.planners["path_vel_decomp_planner"] \
                .shared.params.write_debug_data
            if rec["write_debug_data"][-1:] != [seen]:
                rec["write_debug_data"].append(seen)

        PlanningApp.update = counted
    elif app == "control":
        from tpl_tpu_torch.application.control_app import ControlApp
        update = ControlApp.update

        def solves(self):
            n0 = itm.launches
            try:
                update(self)
            except BaseException:
                # SIGTERM ended the process inside this update: what it
                # launched has no finished solve
                out["interrupted_launches"] = itm.launches - n0
                raise
            mpc = self.controllers["model_predictive_controller"]
            if mpc.opt.updates != out.get("mpc_solves", 0):
                out.setdefault("first", time.perf_counter())
                out["last"] = time.perf_counter()
            out["mpc_solves"] = mpc.opt.updates

        ControlApp.update = solves
    main_fn = {"env": mains.env_main, "planning": mains.planning_main,
               "control": mains.control_main}[app]
    t0 = time.perf_counter()
    try:
        main_fn(app_id)
    finally:
        if app != "env":
            torch.cuda.synchronize()
        out.update(wall_s=time.perf_counter() - t0, launches=counts())
        print(json.dumps(out), flush=True)


def _gui_json(gui, path, body=None):
    import urllib.request
    req = urllib.request.Request(
        f"http://127.0.0.1:{gui.port}{path}",
        data=None if body is None else json.dumps(body).encode(),
        method="GET" if body is None else "POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read() or b"{}")


def _scene_png(gui):
    """GET /scene.png: a PNG where matplotlib imports, else the 500 that
    carries matplotlib's ImportError (it must not pass quietly)."""
    import importlib.util
    import urllib.error
    import urllib.request
    url = f"http://127.0.0.1:{gui.port}/scene.png"
    try:
        with urllib.request.urlopen(url, timeout=60) as r:
            body, code = r.read(), r.status
    except urllib.error.HTTPError as e:
        body, code = e.read(), e.code
    if importlib.util.find_spec("matplotlib") is not None:
        if code != 200 or body[:8] != b"\x89PNG\r\n\x1a\n":
            raise AssertionError(f"/scene.png: {code} {body[:200]!r}")
        return f"a PNG of {len(body)} bytes"
    if code != 500 or b"matplotlib" not in body:
        raise AssertionError(f"/scene.png without matplotlib: {code} "
                             f"{body[:200]!r}")
    return f"500 (no matplotlib here): {body.decode()[:120]}"


def _wait_for(what, cond, procs, timeout):
    """Polls ``cond`` until it holds; raises if a process of ``procs`` ended
    or ``timeout`` s passed."""
    start = time.time()
    while not cond():
        for name, p in procs.items():
            if p.poll() is not None:
                raise AssertionError(f"{name} ended ({p.returncode}) while "
                                     f"waiting for {what}")
        if time.time() - start > timeout:
            raise AssertionError(f"no {what} in {timeout} s")
        time.sleep(0.05)


def deploy_phase():
    """The multi-process deployment on the card (phase 26 of the module's
    docstring).  Returns {"launches": {kernel: launches in the children}}."""
    import pickle
    import urllib.error
    from tpl_tpu_torch.gui import GuiServer
    from tpl_tpu_torch.util import StoreRegistry, store_paths
    from tpl_tpu_torch.util.shm_store import remove_app_stores

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    logs = os.path.join(root, "build", "deploy")
    os.makedirs(logs, exist_ok=True)
    app_id = f"smoke{os.getpid()}"
    remove_app_stores(app_id)
    env = dict(os.environ, PYTHONPATH=root, TPL_TPU_SHM="1",
               TPL_TPU_NO_RELOAD="1")
    cmds = {name: [sys.executable, os.path.abspath(__file__),
                   "--deploy-child", name, app_id] for name in DEPLOY_APPS}
    cmds["sim"] = [sys.executable, "-m", "tpl_tpu_torch.simulation.tplsim",
                   "attach", "--scenario", "demo/country_follow", "--app-id",
                   app_id, "--no-reload", "--max-t", str(2 * DEPLOY_LEG_T)]
    procs, files = {}, {}
    shm_was = os.environ.get("TPL_TPU_SHM")
    gui = None
    try:
        for name, cmd in cmds.items():
            files[name] = open(os.path.join(logs, f"{name}.log"), "w+")
            procs[name] = subprocess.Popen(cmd, cwd=root, env=env,
                                           stdout=files[name],
                                           stderr=subprocess.STDOUT)
        # attached by app id: sets TPL_TPU_SHM=1 here (put back below)
        gui = GuiServer(app_id=app_id, port=0).start()
        planning = gui.planning_store

        def state():
            return _gui_json(gui, "/state.json")

        def running():
            try:
                return state()["running"]
            except urllib.error.HTTPError:     # no sim state published yet
                return False

        def has_names():
            planning.revalidate()
            return "planner_names" in planning
        _wait_for("the planning store", has_names, procs, 300)
        _wait_for("the sim running", running, procs, 300)
        first = state()
        params = _gui_json(gui, "/params.json")
        rstp_name = "path_vel_decomp_planner"
        if (first["planning"]["active"] != rstp_name
                or params["planning"][rstp_name]["horizon"] != RSTP_H):
            raise AssertionError(f"the scenario's sets: {first['planning']}")
        print(f"deploy: GUI on port {gui.port}: t={first['t']:.2f} s, "
              f"planner {first['planning']['active']}, controller "
              f"{first['control']['active']}; /params.json planning "
              f"{sorted(params['planning'])}")
        _wait_for("the first plan", lambda: (planning.revalidate() or len(
            planning.trajectory.x) == RSTP_H), procs, 300)
        t_plan = state()["t"]
        print("deploy: GET /scene.png: " + _scene_png(gui))

        # leg 1: a param edit through the GUI reaches the planning
        # process's bundle; the planner publishes its debug accordingly
        def debug_has_path():
            planning.revalidate()
            return "opt_path" in vars(getattr(planning, rstp_name).debug)
        edits = []
        for on in (False, True):
            _gui_json(gui, "/param", {"target": "planning", "name":
                                      rstp_name, "param": "write_debug_data",
                                      "value": on})
            t0 = time.perf_counter()
            _wait_for(f"the planner's debug with write_debug_data={on}",
                      lambda: debug_has_path() == on, procs, 30)
            edits.append((on, (time.perf_counter() - t0) * 1e3))
        print("deploy: GUI param edits seen in the planning process's "
              "published debug after (ms): " + ", ".join(
                  f"write_debug_data={on} {ms:.1f}" for on, ms in edits))
        _wait_for("leg 1's end", lambda: state()["t"] >= DEPLOY_LEG_T,
                  procs, 300)
        _gui_json(gui, "/select", {"planner": DEPLOY_SWITCH})
        mid = state()
        print(f"deploy: leg 1 to t={mid['t']:.2f} s (first plan at "
              f"t={t_plan:.2f} s), ego x {mid['ego']['x']:.2f} v "
              f"{mid['ego']['v']:.2f}; POST /select {DEPLOY_SWITCH}")
        code = procs["sim"].wait(timeout=300)
        last = state()
        sizes = {}
        for name, store in (("sim", gui.sim_store), ("planning", planning),
                            ("control", gui.control_store),
                            ("env", gui.env._shm)):
            store.revalidate()
            sizes[name] = len(pickle.dumps(store._attrs,
                                           protocol=pickle.HIGHEST_PROTOCOL))
        ci = StoreRegistry.get(store_paths(app_id).control_input)
        ci.revalidate()
        sizes["control_input"] = len(pickle.dumps(
            ci._attrs, protocol=pickle.HIGHEST_PROTOCOL))
    finally:
        if gui is not None:
            gui.stop()
        for p in procs.values():
            if p.poll() is None:
                p.terminate()
        for name, p in procs.items():
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        if shm_was is None:
            os.environ.pop("TPL_TPU_SHM", None)
        else:
            os.environ["TPL_TPU_SHM"] = shm_was
        StoreRegistry.clear()
        remove_app_stores(app_id)
    text = {}
    for name, f in files.items():
        f.seek(0)
        text[name] = f.read()
        f.close()
    for name, p in procs.items():
        if p.returncode != 0:
            raise AssertionError(f"{name} exited {p.returncode}:\n"
                                 + text[name][-3000:])
    if code != 0 or "rule violations: 0" not in text["sim"] \
            or last["violations"]:
        raise AssertionError("tplsim attach: " + text["sim"][-2000:])
    print("deploy: tplsim attach: " + " | ".join(
        line.strip() for line in text["sim"].strip().splitlines()[-3:]))
    stats = {name: json.loads(text[name].strip().splitlines()[-1])
             for name in DEPLOY_APPS}
    moved = last["ego"]["x"] - first["ego"]["x"]
    print(f"deploy: t={last['t']:.2f} s, ego x {first['ego']['x']:.2f} -> "
          f"{last['ego']['x']:.2f} ({moved:.2f} m), v {last['ego']['v']:.2f}"
          f" m/s, planner {last['planning']['active']}, 0 violations")
    if not moved > 20.0:
        raise AssertionError(f"the ego moved {moved:.2f} m")
    by = stats["planning"]["by_planner"]
    rs, dp = by.get("path_vel_decomp_planner"), by.get(DEPLOY_SWITCH)
    if rs is None or dp is None:
        raise AssertionError(f"planners that ran: {sorted(by)}")
    for name, rec in (("path_vel_decomp_planner", rs), (DEPLOY_SWITCH, dp)):
        print(f"deploy: planning process, {name}: {rec['updates']} updates, "
              f"{rec['dp_replans']} DP replans, launches {rec['launches']}")
    if not (rs["launches"]["ilqr_rstp"] > 0
            and rs["launches"]["rstp_rampify"] > 0):
        raise AssertionError("no RSTP launches in leg 1")
    if not (dp["dp_replans"] > 0 and dp["launches"]["latlon_backward_slice"]
            == (DEMO_SPEC["t_steps"] - 2) * dp["dp_replans"]
            and dp["launches"]["ilqr_rstp"] == 0):
        raise AssertionError(f"leg 2's launches: {dp}")
    if rs["write_debug_data"] != [True, False, True]:
        raise AssertionError("write_debug_data seen by the planning "
                             f"process: {rs['write_debug_data']}")
    ctl = stats["control"]
    if not (ctl["launches"]["ilqr_tracking_mpc"] == ctl["mpc_solves"]
            + ctl.get("interrupted_launches", 0) and ctl["mpc_solves"] > 0):
        raise AssertionError(f"control: {ctl['launches']}, "
                             f"{ctl['mpc_solves']} solves, "
                             f"{ctl.get('interrupted_launches', 0)} launches "
                             "of the update SIGTERM ended")
    def per_s(n, rec):
        return n / max(rec["last"] - rec["first"], 1e-9)

    for name in DEPLOY_APPS:
        s = stats[name]
        rate = ""
        if name == "planning":
            rate = "updates/s while active: " + ", ".join(
                f"{n} {per_s(r['updates'], r):.1f}" for n, r in by.items()
                if r["updates"] > 1)
            rate += (f"; {DEPLOY_SWITCH} replans/s "
                     f"{per_s(dp['dp_replans'], dp):.2f}")
        elif name == "control":
            rate = (f"MPC solves/s from the first to the last "
                    f"{per_s(ctl['mpc_solves'], ctl):.1f}")
        trips = "; ".join(
            f"{f} {kind} {n}, mean {ms / n:.3f} ms, max {mx:.3f} ms"
            for f, kinds in sorted(s["locks"].items())
            for kind, (n, ms, mx) in sorted(kinds.items()))
        print(f"deploy: {name} process ({s['wall_s']:.1f} s): {rate}"
              f"{'; ' if rate else ''}round trips: {trips}")
    print("deploy: store sizes (pickled bytes): " + ", ".join(
        f"{k} {v}" for k, v in sizes.items()))
    print(f"deploy: phase wall {time.perf_counter() - t_phase:.1f} s")
    launches = {k: stats["planning"]["launches"][k]
                for k in ("ilqr_rstp", "rstp_rampify",
                          "latlon_backward_slice")}
    launches["ilqr_tracking_mpc"] = ctl["launches"]["ilqr_tracking_mpc"]
    return {"launches": launches}


def main(argv=()):
    import argparse
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent-csrc", action="append", metavar="DIR",
                    help="a directory with another version of any of the "
                    "kernel sources the phases compare (and the headers "
                    "they include): "
                    "built with the same flags, run in turns with the tree's "
                    "kernels on the same inputs, results and times printed")
    ap.add_argument("--kernels-only", action="store_true",
                    help="build, probe, then only the action-min, rampify, "
                    "time-indexed MPC, lon DP, lateral sweep, NaN rule and "
                    "graph DP kernel checks and times on seeded inputs; "
                    "drives no loop and prints no result line")
    ap.add_argument("--host-profile", type=int, default=0, metavar="TICKS",
                    help="build, then cProfile TICKS ticks of the vendored "
                    "RSTP loop with the host C routes off and on; prints "
                    "the leading functions and no result line")
    ap.add_argument("--dp-first-replan", metavar="DIR", default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--deploy-child", nargs=2, metavar=("APP", "APP_ID"),
                    default=None, help=argparse.SUPPRESS)
    opts = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if opts.dp_first_replan is not None:
        dp_first_replan_child(opts.dp_first_replan)
        return 0
    if opts.deploy_child is not None:
        deploy_child(*opts.deploy_child)
        return 0
    import tpl_tpu_torch
    from tpl_tpu_torch import _build
    from tpl_tpu_torch import _latency as lat
    from tpl_tpu_torch import native
    from tpl_tpu_torch.optim import ilqr_rstp as rstp
    from tpl_tpu_torch import scenes
    from tpl_tpu_torch.optim import ilqr_tracking_mpc as itm
    from tpl_tpu_torch.optim import ilqr_tracking_mpc_time as itt
    from tpl_tpu_torch.planning.dyn_prog import latlon_action_min as lam
    from tpl_tpu_torch.planning.dyn_prog import lat_lon_kernel as tllk
    from tpl_tpu_torch.planning.dyn_prog import lon_kernel as tlk
    from tpl_tpu_torch.planning.dyn_prog import poly_lat_kernel as plk
    from tpl_tpu_torch.planning.path_vel_decomp import rstp_rampify as rmp
    from tpl_tpu_torch.planning.idm_sampling import idm_kernel as idk
    from tpl_tpu_torch.planning.poly_sampling import poly_kernel as pok
    from tpl_tpu_torch.planning.poly_sampling import poly_sampling_planner \
        as psp
    from tpl_tpu_torch.planning.dyn_prog import dp_environment as dpe
    from tpl_tpu_torch.planning.dyn_prog import poly_planner_kernel as ppk
    from tpl_tpu_torch.optim import ilqr_generic as ig

    card = smi("name,power.limit")
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    tpl_tpu_torch.use_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    _build.build(KERNELS)
    for mod in (lam, itm, rstp, rmp, lat, tlk, plk, idk, pok, dpe, ppk, itt,
                ig):
        mod._kernel()
    ig._kernel(dtype=torch.float32)
    native.get_lib()
    native.get_shm_lib()
    print(f"built {', '.join(KERNELS)}, native/hostops.cpp and "
          f"native/shmstore.cpp in {time.perf_counter() - t0:.2f} s")
    for name in KERNELS:
        log = _build.BUILD_LOG.get(name, "").strip()
        if log:
            print(log)

    dev = torch.device("cuda")
    phases = {}

    def phase(name, fn, *args, **kw):
        t = time.perf_counter()
        res = fn(*args, **kw)
        phases[name] = time.perf_counter() - t
        print(f"phase {name}: {phases[name]:.1f} s", flush=True)
        return res

    if opts.host_profile:
        phase("host profile", host_profile_phase, native, opts.host_profile)
        print("host profile only: no kernel was checked")
        return 0
    cycles, mhz = phase("latency probe", probe_phase, lat, itm, dev)
    am = phase("action_min kernel", kernel_phase, lam, tllk, dev,
               opts.parent_csrc)
    if opts.kernels_only:
        phase("rampify kernel", rampify_phase, rmp, [], dev, mhz,
              opts.parent_csrc)
        phase("time-indexed MPC kernel", mpc_time_phase, itt, scenes, [], dev,
              cycles, mhz, opts.parent_csrc)
        phase("lon DP backward slice", lon_seeded_phase, tlk, dev,
              opts.parent_csrc)
        phase("lon DP forward and lateral sweep", fas_seeded_phase, tlk,
              plk, dev, mhz, opts.parent_csrc)
        phase("NaN rule", nan_rule_phase, tlk, lam, tllk, plk, dev,
          opts.parent_csrc)
        phase("graph DP kernels", dp_poly_kernel_phase, dpe, ppk,
              dp_standin_first(dpe, ppk, dev), dev, cycles, mhz,
              opts.parent_csrc)
        phase("batched DP slice", batch_slice_phase, lam, tllk, dev, mhz,
              opts.parent_csrc)
        print("kernels only: no loop was driven")
        return 0
    # the genopt MPC's generated source, built beside the next phases (its
    # nvcc is a process of its own; the thread is joined by the genopt
    # phase, and at exit if a phase before it fails)
    gen_build = {}
    gen_build["thread"] = threading.Thread(target=build_genopt_source,
                                           args=(gen_build,))
    gen_build["thread"].start()
    # another ilqr_generic.cu of --parent-csrc (its native library and the
    # genopt MPC's source against its headers), built likewise
    parent_build = {}
    generic_dirs = [d for d in parents_with(opts.parent_csrc, "ilqr_generic")
                    if all(os.path.isfile(os.path.join(d, f))
                           for f in GENERIC_SOURCES)]
    if generic_dirs:
        parent_build["thread"] = threading.Thread(
            target=build_generic_parents, args=(generic_dirs, parent_build))
        parent_build["thread"].start()
    # the user problems' traced structs, built likewise
    user_build = {}
    user_build["thread"] = threading.Thread(target=build_user_sources,
                                            args=(user_build,))
    user_build["thread"].start()
    # the traced operations' two problems, built likewise
    ops_build = {}
    ops_build["thread"] = threading.Thread(target=build_traced_ops_sources,
                                           args=(ops_build,))
    ops_build["thread"].start()
    phase("DP slice", slice_phase, lam, tllk)
    loop = phase("DP closed loop", closed_loop_phase, lam, itm)
    dp_first = phase("DP first replan", dp_first_replan_phase,
                     opts.parent_csrc)
    (ilqr_err, (ilqr_ms, ilqr_wrapper_ms, ilqr_plain_ms), mpc_its,
     single_us) = phase("tracking-MPC kernel", ilqr_phase, itm,
                        loop["picked"], dev, mhz, opts.parent_csrc)
    native_rec, restore = record_native_calls(native)
    for k in native.ROUTES:
        native.calls[k] = 0
    generic_mpc0 = ig.by_problem.get("trajectory_tracking_mpc", 0)
    try:
        follow = phase("RSTP closed loop, country_follow", rstp_loop_phase,
                       rstp, rmp, itm, "demo/country_follow", LOOP_TICKS,
                       record=True)
    finally:
        restore()
    # the vendored controller (HORIZON_MAX = 60) keeps the MPC's own kernel
    if (follow["launches"]["ilqr_tracking_mpc"] == 0
            or ig.by_problem.get("trajectory_tracking_mpc", 0)
            != generic_mpc0):
        raise AssertionError("the vendored controller left ilqr_tracking_mpc")
    print(f"the vendored controller: {follow['launches']['ilqr_tracking_mpc']}"
          " ilqr_tracking_mpc launches, none of the generic kernel")
    loop_calls = dict(native.calls)
    overtake = phase("RSTP closed loop, country_overtake", rstp_loop_phase,
                     rstp, rmp, itm, "demo/country_overtake", OVERTAKE_TICKS,
                     screen=False)
    kern = phase("RSTP kernels", rstp_kernel_phase, rstp, rmp,
                 follow["picked"], follow["scans"], dev, mhz,
                 opts.parent_csrc)
    phase("host C routes", native_phase, native, native_rec, loop_calls)
    bat = phase("batched tracking MPC", batched_phase, itm, dev, cycles, mhz,
                single_us, opts.parent_csrc)
    fas = phase("FAS closed loop, poly_lat_dp_lon_planner", fas_loop_phase,
                tlk, plk, rmp, FAS, FAS_TICKS, record=True)
    lattice = phase("FAS closed loop, lattice_planner", fas_loop_phase, tlk,
                    plk, rmp, LATTICE, FAS_TICKS, record=True)
    fk = phase("FAS kernels", fas_kernel_phase, tlk, plk, rmp,
               {"fas": fas["rec"], "lattice": lattice["rec"]}, dev, cycles,
               mhz, opts.parent_csrc)
    phase("NaN rule", nan_rule_phase, tlk, lam, tllk, plk, dev,
          opts.parent_csrc)
    idm = phase("IDM closed loop, country_overtake", rollout_loop_phase, idk,
                pok, IDM, ROLLOUT_TICKS)
    poly = phase("poly sampling closed loop, country_follow",
                 rollout_loop_phase, idk, pok, POLY, ROLLOUT_TICKS)
    ik = phase("IDM kernels", idm_kernel_phase, idk, idm["first"], dev,
               cycles, mhz, opts.parent_csrc)
    pk = phase("poly sampling kernel", poly_kernel_phase, pok, psp,
               poly["first"], dev, cycles, mhz, opts.parent_csrc)
    gdp = phase("graph DP closed loop", dp_poly_loop_phase, dpe, ppk,
                DP_POLY_TICKS)
    gk = phase("graph DP kernels", dp_poly_kernel_phase, dpe, ppk,
               gdp["first"], dev, cycles, mhz, opts.parent_csrc)
    ctl = {name: phase(f"closed loop, {name}", controller_loop_phase, itt,
                       itm, rstp, rmp, name, CONTROLLER_TICKS)
           for name in CONTROLLER_JAX_END}
    tk = phase("time-indexed MPC kernel", mpc_time_phase, itt, scenes,
               ctl[TIME_MPC]["picked"], dev, cycles, mhz, opts.parent_csrc)
    phase("tplsim run", tplsim_phase)
    phase("demo legs", demo_legs_phase)
    phase("record and replay", record_replay_phase)
    parents = generic_parent_libs(parent_build)
    if parents:
        print(f"the parent generic sources built in {parent_build['s']:.1f} s"
              " beside the phases")
    gen = phase("genopt MPC", genopt_phase, dev, gen_build, cycles, mhz,
                parents)
    igk = phase("iLQR generic", generic_phase, ig, dev, cycles, mhz, parents)
    trk = phase("tracking MPCs, generic kernel", tracking_generic_phase, ig,
                itm, itt, dev, cycles, mhz)
    smooth = phase("RSTP smooth_only", smooth_only_phase, ig, rstp, itm)
    user = phase("user problems through the generic kernel",
                 user_problem_phase, ig, dev, cycles, mhz, user_build)
    ops = phase("traced operations through the generic kernel",
                traced_ops_phase, ig, dev, cycles, mhz, ops_build)
    bs = phase("batched DP slice", batch_slice_phase, lam, tllk, dev, mhz,
               opts.parent_csrc)
    dry = phase("dryrun_multichip", dryrun_phase, lam, itm, idk)
    dep = phase("multi-process deployment", deploy_phase)
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")

    # the bounds, from this run's shapes and iteration counts, and the
    # launches per tick of the vendored loop / per DP replan
    launches = follow["launches"]
    vel = "velocity_profile_space"
    vel_ms, vel_wrapper_ms, vel_plain_ms = kern["ilqr_times"][vel]
    vel_H, vel_n_ref, vel_T = kern["shapes"][vel]
    vel_its = kern["iterations"][vel]
    S, DS, L = (DEMO_SPEC[k] for k in ("s_steps", "ds_steps", "l_steps"))
    bounds = {
        "latlon_action_min": (lam.bound_ms(S, DS, L),
                              lam.chain_ms(cycles, mhz)),
        "ilqr_tracking_mpc": (itm.bound_ms(MPC_H, 128, MPC_H, mpc_its),
                              itm.chain_ms(MPC_H, MPC_H, mpc_its, cycles,
                                           mhz)),
        "ilqr_rstp": (rstp.bound_ms(vel, vel_H, vel_n_ref, vel_T, vel_its),
                      rstp.chain_ms(vel, vel_H, vel_T, vel_its, cycles, mhz)),
        "rstp_rampify": (rmp.bound_ms(RSTP_H), rmp.chain_ms(RSTP_H, cycles,
                                                            mhz)),
        "latlon_backward_slice": (lam.slice_bound_ms(S, DS, L),
                                  lam.slice_chain_ms(cycles, mhz))}
    rows = [
        {"name": "latlon_action_min",
         "source": "tpl_tpu_torch/csrc/latlon_action_min.cu",
         "replaces": "tpl_tpu/planning/dyn_prog/latlon_pallas.py:168",
         "launches": loop["am_launches"],
         "per_replan": loop["am_launches"] / max(loop["replans"], 1),
         "max_abs_err": am["err"], "ms": am["ms"],
         "wrapper_ms": am["wrapper_ms"], "plain_ms": am["plain_ms"]},
        {"name": "ilqr_tracking_mpc",
         "source": "tpl_tpu_torch/csrc/ilqr_tracking_mpc.cu",
         "replaces": "tpl_tpu/optim/ilqr.py:126",
         "launches": launches["ilqr_tracking_mpc"],
         "launches_per_tick": launches["ilqr_tracking_mpc"] / LOOP_TICKS,
         "max_abs_err": max(ilqr_err, loop["err"]),
         "ms": ilqr_ms, "wrapper_ms": ilqr_wrapper_ms,
         "plain_ms": ilqr_plain_ms},
        {"name": "ilqr_rstp", "source": "tpl_tpu_torch/csrc/ilqr_rstp.cu",
         "replaces": "tpl_tpu/optim/ilqr.py:126",
         "launches": launches["ilqr_rstp"],
         "launches_per_tick": launches["ilqr_rstp"] / LOOP_TICKS,
         "max_abs_err": max(kern["ilqr_err"], follow["err"],
                            overtake["err"]),
         "ms": vel_ms, "wrapper_ms": vel_wrapper_ms,
         "plain_ms": vel_plain_ms},
        {"name": "rstp_rampify",
         "source": "tpl_tpu_torch/csrc/rstp_rampify.cu",
         "replaces": "tpl_tpu/planning/path_vel_decomp/fused_replan.py:244",
         "launches": launches["rstp_rampify"],
         "launches_per_tick": launches["rstp_rampify"] / LOOP_TICKS,
         "max_abs_err": kern["scan_err"],
         "ms": kern["scan_ms"][0], "wrapper_ms": kern["scan_ms"][1],
         "plain_ms": kern["scan_ms"][2]},
        {"name": "latlon_backward_slice",
         "source": "tpl_tpu_torch/csrc/latlon_action_min.cu",
         "replaces": "tpl_tpu/planning/dyn_prog/lat_lon_kernel.py:276",
         "launches": loop["slice_launches"],
         "per_replan": loop["slice_launches"] / max(loop["replans"], 1),
         "max_abs_err": am["fused"]["err"], "ms": am["fused"]["ms"],
         "wrapper_ms": am["fused"]["wrapper_ms"],
         "plain_ms": am["fused"]["plain_ms"]}]
    # the DP loop's first replan (its tick's wall; the kernel phase has
    # launched the library's kernels before it) and, with a parent source,
    # in fresh processes
    rows[0].update(first_replan_tick_ms=loop["first_replan_ms"],
                   fresh_first_replan_ms=dp_first)
    for row in rows:
        (ms, by), chain = bounds[row["name"]]
        row.update(route="cuda", bound_ms=ms, bound_by=by, chain_ms=chain,
                   library_ms=NO_LIBRARY)
    # the batch: the float64 numbers of the bench's batch under the
    # contract's keys (chain_ms: the longest scenario's dependent chain,
    # which with the roofline makes the design-independent bound,
    # batch_bound_ms), the batch near the course and the float32
    # instantiation's beside them
    b64, b32 = bat["float64"], bat["float32"]
    row = {"name": "ilqr_tracking_mpc_batched", "route": "cuda",
           "source": "tpl_tpu_torch/csrc/ilqr_tracking_mpc.cu",
           "replaces": "tpl_tpu/optim/batched.py:30", "batch": BATCH,
           "library_ms": NO_LIBRARY}

    def batch_keys(r):
        return {
            "launches": r["launches"], "max_abs_err": r["err"],
            "ms": r["ms"], "wrapper_ms": r["wrapper_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["roof"][0],
            "bound_by": r["roof"][1], "chain_ms": r["chain"],
            "batch_bound_ms": r["bound"][0], "batch_bound_by": r["bound"][1],
            "floor_ms": r["floor"],
            "solves_per_s": BATCH / r["wrapper_ms"] * 1e3,
            "kernel_solves_per_s": BATCH / r["ms"] * 1e3,
            "resident_scenarios_per_sm": r["resident"],
            "scenarios_per_block": r["slots"],
            "shared_bytes": r["bytes"][0], "scenario_bytes": r["bytes"][1],
            "candidates_rolled": r["rolled"],
            "scenario0_phases_us": r["phases"],
            "line_searches_by_candidate": r["hist"],
            "ms_by_batch": r["by_batch"],
            "wrapper_ms_by_batch": r["wrapper_by_batch"],
            "parent_ms_by_batch": r["parent_by_batch"],
            "max_abs_err_all": r["err_all"],
            "share_within_tolerance": r["share"],
            "near_course_ms": r["tame"]["ms"],
            "near_course_wrapper_ms": r["tame"]["wrapper_ms"],
            "near_course_bound_ms": r["tame"]["roof"][0],
            "near_course_chain_ms": r["tame"]["chain"],
            "near_course_batch_bound_ms": r["tame"]["bound"][0],
            "near_course_floor_ms": r["tame"]["floor"],
            "near_course_candidates_rolled": r["tame"]["rolled"],
            "team_scenarios_per_sm": r["team"],
            "candidates_a_round": r["group"],
            "warm_start_decision_split": r["split"]}

    row.update(batch_keys(b64))
    row.update({"float32_" + k: v for k, v in batch_keys(b32).items()})
    rows.append(row)
    # the FAS chain's kernels: launches on its loop, the lattice loop's
    # beside them; the checks on seeded inputs and on the FAS loop's, the
    # lattice loop's beside them; times on the FAS loop's inputs
    for name, source, replaces in FAS_ROWS:
        r = fk[name]
        row = {
            "name": name, "route": "cuda",
            "source": f"tpl_tpu_torch/csrc/{source}", "replaces": replaces,
            "launches": fas["counts"][name],
            "per_replan": fas["counts"][name] / fas["replans"],
            "lattice_launches": lattice["counts"][name],
            "lattice_per_replan": (lattice["counts"][name]
                                   / lattice["replans"]),
            "max_abs_err": r["err"], "lattice_max_abs_err": r["lattice_err"],
            "ms": r["ms"], "wrapper_ms": r["wrapper_ms"],
            "lattice_wrapper_ms": r["lattice_wrapper_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "chain_ms": r["chain"],
            "library_ms": NO_LIBRARY}
        # the share of lon nodes whose chosen jerk differs; the sweep's
        # largest relative cost difference
        for k, out in (("share", "jerk_flip_share"),
                       ("cost_rel", "max_cost_rel_err")):
            if k in r:
                row[out] = r[k]
                row["lattice_" + out] = r["lattice_" + k]
        # the device time from CUDA graphs; the backward slice's blocks,
        # its lattice slice's device time and the other source's times in
        # turns
        if "graph_ms" in r:
            row["graph_ms"] = r["graph_ms"]
        if "plan" in r:
            row.update(r["plan"], lattice_graph_ms=r["lattice_graph_ms"],
                       parent_ms=r["parent"])
        if "phases_us" in r:
            row.update(phases_us=r["phases_us"], parent_ms=r["parent"])
        # the sweep's: the lattice loop's grid from CUDA graphs, the sweep's chain alone, the lattice loop's
        # bounds, the selection's updates on each loop's first replan
        for k in ("lattice_graph_ms", "sweep_chain_ms",
                  "lattice_bound_ms", "lattice_chain_ms",
                  "selection_updates"):
            if k in r and k not in row:
                row[k] = r[k]
        # each loop's first replan (runtime_dp; the libraries load their
        # code when bound)
        row.update(first_replan_ms=fas["replan_ms"][0],
                   lattice_first_replan_ms=lattice["replan_ms"][0])
        rows.append(row)
    # the rollout planners' kernels: launches on their loops, the checks on
    # the seeded scenes, the loops' first replans and the JAX bench's scenes,
    # times at the bench's widths (IDM: C=16,384; poly: C=30)
    for name, source, replaces in ROLLOUT_ROWS:
        loop_run = poly if name == "poly_sampling" else idm
        r = pk if name == "poly_sampling" else ik[name]
        row = {
            "name": name, "route": "cuda",
            "source": f"tpl_tpu_torch/csrc/{source}", "replaces": replaces,
            "launches": loop_run["counts"][name],
            "per_replan": loop_run["counts"][name] / loop_run["replans"],
            "launches_per_tick": loop_run["counts"][name] / loop_run["ticks"],
            "max_abs_err": r["err"], "ms": r["ms"],
            "wrapper_ms": r["wrapper_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "chain_ms": r["chain"], "library_ms": NO_LIBRARY}
        if name == "poly_sampling":
            row.update(graph_ms=r["graph_ms"], parent_ms=r["parent"],
                       serial_chain_ms=r["serial_chain"],
                       phases_us=r["phases_us"])
        else:
            row.update(candidates=IDM_C, blocks_per_sm=r["blocks_per_sm"],
                       registers=r["registers"], spill_bytes=r["spill_bytes"],
                       full_scan_bound_ms=r["full_scan_bound"][0],
                       needed_work=r["work"], loop_ms=r["loop_ms"],
                       loop_wrapper_ms=r["loop_wrapper_ms"],
                       rollouts_per_s=r["rollouts_per_s"],
                       selection_flips=r["selection_flips"])
        rows.append(row)
    # the graph DP planner's kernels: launches on its loop, the checks on
    # the seeded scenes and the loop's first replan, times on the loop's
    # first replan (the evaluation and propagation at start index (7, 10))
    for name, source, replaces in DP_POLY_ROWS:
        r = gk[name]
        extra = {}
        if name == "dir_dist_map":
            extra = dict(per_slice_bound_ms=r["per_slice_bound"][0],
                         phases_us=r["phases_us"])
        elif name == "poly_eval_edges":
            extra = dict(full_scan_bound_ms=r["full_scan_bound"][0],
                         steps_needed=r["steps_needed"],
                         phases_cycles=r["phases"])
        else:
            extra = dict(serial_chain_ms=r["serial_chain"],
                         phases_us=r["phases_us"])
        if "graph_ms" in r:
            extra.update(graph_ms=r["graph_ms"], parent_ms=r["parent"])
        rows.append({
            "name": name, "route": "cuda",
            "source": f"tpl_tpu_torch/csrc/{source}", "replaces": replaces,
            "launches": gdp["counts"][name],
            "per_replan": gdp["counts"][name] / gdp["replans"],
            "launches_per_tick": gdp["counts"][name] / DP_POLY_TICKS,
            "max_abs_err": r["err"], "ms": r["ms"],
            "wrapper_ms": r["wrapper_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "chain_ms": r["chain"], "library_ms": NO_LIBRARY,
            "runtime_environment_median_ms": float(np.median(gdp["env_ms"])),
            "runtime_planning_median_ms": float(np.median(gdp["plan_ms"]))}
            | extra)
    # the time-indexed MPC: launches on its loop, the checks on the seeded
    # cases and the loop's solves, times on the loop's first recorded solve
    tl, tloop = tk["loop"], ctl[TIME_MPC]
    rows.append({
        "name": "ilqr_tracking_mpc_time", "route": "cuda",
        "source": "tpl_tpu_torch/csrc/ilqr_tracking_mpc_time.cu",
        "replaces": "tpl_tpu/optim/ilqr.py:126",
        "launches": tloop["launches"]["ilqr_tracking_mpc_time"],
        "launches_per_tick": (tloop["launches"]["ilqr_tracking_mpc_time"]
                              / tloop["ticks"]),
        "max_abs_err": tk["err"], "ms": tl["ms"],
        "wrapper_ms": tl["wrapper_ms"], "plain_ms": tl["plain_ms"],
        "bound_ms": tl["bound"][0], "bound_by": tl["bound"][1],
        "chain_ms": tl["chain"], "library_ms": NO_LIBRARY,
        "iterations": tl["iterations"], "phases_us": tl["phases_us"],
        "parent_ms": tl["parent"],
        "registers": ptxas_usage("ilqr_tracking_mpc_time")[0],
        "loop_solve_ms": tloop["solve_ms"],
        "cold_ms": tk["times"]["utm_straight"]["ms"],
        "control_wall_median_ms": {
            n: float(np.median(r["control_ms"])) for n, r in ctl.items()},
        "control_wall_max_ms": {
            n: float(np.max(r["control_ms"])) for n, r in ctl.items()}})
    # the DP slice for a scenario batch: launches on the dryrun's path, the
    # checks at B = 1 and 8, times at B = 8 (from CUDA graphs) beside B
    # one-scenario launches
    rows.append({
        "name": "latlon_backward_slice_batched", "route": "cuda",
        "source": "tpl_tpu_torch/csrc/latlon_action_min.cu",
        "replaces": "tpl_tpu/parallel/kernels.py:53",
        "launches": dry["counts"]["latlon_backward_slice_batched"],
        "per_batch_solve": DEMO_SPEC["t_steps"] - 2,
        "batch": SLICE_BATCH_TIMED, "max_abs_err": bs["err"],
        "ms": bs["ms"], "single_launches_ms": bs["single_ms"],
        "event_ms": bs["event_ms"],
        "single_launches_event_ms": bs["single_event_ms"],
        "wrapper_ms": bs["wrapper_ms"], "plain_ms": bs["plain_ms"],
        "bound_ms": bs["bound"][0], "bound_by": bs["bound"][1],
        "library_ms": NO_LIBRARY,
        "scenarios_per_s": bs["times"][SLICE_BATCH_TIMED]["scenarios_per_s"],
        "by_batch": {B: {k: v for k, v in t.items() if k != "bound"}
                     | {"bound_ms": t["bound"][0]}
                     for B, t in bs["times"].items()},
        "parent_graph_ms": bs["parent_ms"], "phases_us": bs["phases_us"],
        "registers_local_bytes": bs["attributes"],
        "dryrun_launches": dry["counts"], "dryrun_first_s": dry["first"],
        "dryrun_warm_s": dry["warm"],
        "genopt_mpc_max_abs_err": gen["err"],
        "genopt_mpc_card_ms": gen["card_ms"][1]})
    # the generic AL-iLQR kernel: the native problems (launches on the
    # smooth_only loop; times of ref_line_smoother_k at H=250, the others
    # beside), the genopt MPC's generated kernel (launches in its phase) and
    # the batch at B=2,048 (one launch a batched update)
    sm = igk["times"][("ref_line_smoother_k", GENERIC_H[0])]
    rows.append({
        "name": "ilqr_generic", "route": "cuda",
        "source": "tpl_tpu_torch/csrc/ilqr_generic.cu",
        "replaces": "tpl_tpu/optim/ilqr.py:126",
        "launches": smooth["launches"],
        "per_replan": smooth["launches"] / max(smooth["replans"], 1),
        "max_abs_err": igk["err"], "ms": sm["ms"],
        "wrapper_ms": sm["wrapper_ms"], "plain_ms": sm["plain_ms"],
        "bound_ms": sm["bound"][0], "bound_by": sm["bound"][1],
        "chain_ms": sm["chain"], "library_ms": NO_LIBRARY,
        "by_problem": {f"{n} H={H}": {k: (v[0] if k == "bound" else v)
                                      for k, v in t.items()}
                       for (n, H), t in igk["times"].items()},
        "parent_ms": igk["parent_ms"], "build_figures": igk["figures"],
        "smooth_only_replan_median_ms": smooth["plan_median_ms"],
        "smooth_only_replan_max_ms": smooth["plan_max_ms"]})
    rows.append({
        "name": "ilqr_generic_genopt_mpc", "route": "cuda",
        "source": "tpl_tpu_torch/csrc/ilqr_generic_body.cuh",
        "replaces": "tpl_tpu/optim/ilqr.py:126",
        "launches": gen["launches"], "max_abs_err": gen["err"],
        "ms": gen["ms"], "wrapper_ms": gen["wrapper_ms"],
        "plain_ms": gen["plain_ms"], "bound_ms": gen["bound"][0],
        "bound_by": gen["bound"][1], "chain_ms": gen["chain"],
        "library_ms": NO_LIBRARY, "build_s": gen["build_s"],
        "iterations": gen["iterations"], "split": gen["split"],
        "parent_ms": gen["parent_ms"], "build_figures": gen["figures"]})
    for which in ("ref_line_smoother_k", "genopt_mpc"):
        b = igk["batches"][(which, GENERIC_BATCHES[-1])]
        rows.append({
            "name": f"ilqr_generic_batched_{which}", "route": "cuda",
            "source": "tpl_tpu_torch/csrc/ilqr_generic_body.cuh",
            "replaces": "tpl_tpu/optim/batched.py:30",
            "batch": GENERIC_BATCHES[-1], "launches": 1,
            "max_abs_err": igk["err"], "ms": b["ms"],
            "wrapper_ms": b["wrapper_ms"],
            "plain_ms": igk["batches"][(which, 64)]["plain_ms"],
            "plain_batch": 64, "bound_ms": b["bound"][0],
            "bound_by": b["bound"][1], "chain_ms": b["chain"],
            "library_ms": NO_LIBRARY, "solves_per_s": b["solves_per_s"],
            "design_floor_ms": b["floor"], "geometry": b["geometry"],
            "unit_bytes": b["unit_bytes"], "scenario0_phases_us": b["phases"],
            "ms_by_batch": {B: igk["batches"][(which, B)]["ms"]
                            for B in GENERIC_BATCHES},
            "parent_ms_by_batch": {
                B: igk["batches"][(which, B)]["parent_ms"]
                for B in GENERIC_BATCHES}})
    # the tracking MPCs through the generic kernel (launches in their phase)
    for name in ("trajectory_tracking_mpc", "trajectory_tracking_mpc_time"):
        t = trk["singles"][(name, TRACKING_H[-1])]
        rows.append({
            "name": f"ilqr_generic_{name}", "route": "cuda",
            "source": "tpl_tpu_torch/csrc/ilqr_generic.cu",
            "replaces": "tpl_tpu/optim/ilqr.py:126",
            "launches": len(TRACKING_H), "max_abs_err": t["err"],
            "ms": t["ms"], "wrapper_ms": t["wrapper_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
            "bound_by": t["bound"][1], "chain_ms": t["chain"],
            "library_ms": NO_LIBRARY, "horizon": TRACKING_H[-1],
            "iterations": t["iterations"],
            "by_horizon": {H: {k: (v[0] if k == "bound" else v)
                               for k, v in trk["singles"][(name, H)].items()}
                           for H in TRACKING_H}})
    b = trk["batches"][TIME_BATCHES[-1]]
    rows.append({
        "name": "ilqr_generic_batched_trajectory_tracking_mpc_time",
        "route": "cuda", "source": "tpl_tpu_torch/csrc/ilqr_generic.cu",
        "replaces": "tpl_tpu/optim/batched.py:30",
        "batch": TIME_BATCHES[-1], "launches": 1, "max_abs_err": trk["err"],
        "ms": b["ms"], "wrapper_ms": b["wrapper_ms"],
        "plain_ms": trk["batches"][TIME_BATCHES[0]]["plain_ms"],
        "plain_batch": TIME_BATCHES[0], "bound_ms": b["bound"][0],
        "bound_by": b["bound"][1], "chain_ms": b["chain"],
        "design_floor_ms": b["floor"], "library_ms": NO_LIBRARY,
        "solves_per_s": b["solves_per_s"], "geometry": b["geometry"],
        "ms_by_batch": {B: trk["batches"][B]["ms"] for B in TIME_BATCHES}})
    # the user problems traced into the generic kernel: launches on their
    # main path (the examples' mains, the counts set to 0 just before),
    # times of each example's own solve in float32 (its dtype)
    for name, r in user["singles"].items():
        rows.append({
            "name": f"ilqr_generic_traced_{name}", "route": "cuda",
            "source": "tpl_tpu_torch/csrc/ilqr_generic_body.cuh",
            "replaces": "tpl_tpu/optim/ilqr.py:126",
            "launches": user["main_launches"][name],
            "max_abs_err": r["err_plain"], "ms": r["ms"],
            "wrapper_ms": r["wrapper_ms"], "plain_ms": r["plain_ms"],
            "cpu_plain_ms": r["cpu_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "chain_ms": r["chain"],
            "library_ms": NO_LIBRARY, "dtype": r["dtype"],
            "horizon": r["horizon"], "iterations": r["iterations"],
            "solve_wall_ms": r["solve_wall_ms"],
            "main_ms": user["main_ms"][name], "phases_us": r["phases"],
            "split": r["split"], "float64": r["float64"],
            "build_s": user["build_s"]})
    b = user["batches"][USER_BATCHES[-1]]
    rows.append({
        "name": "ilqr_generic_batched_traced_crane_2d", "route": "cuda",
        "source": "tpl_tpu_torch/csrc/ilqr_generic_body.cuh",
        "replaces": "tpl_tpu/optim/batched.py:30",
        "batch": USER_BATCHES[-1], "launches": 1, "max_abs_err": b["err"],
        "ms": b["ms"], "wrapper_ms": b["wrapper_ms"],
        "plain_ms": user["batches"][USER_BATCHES[0]]["plain_ms"],
        "plain_batch": USER_BATCHES[0], "bound_ms": b["bound"][0],
        "bound_by": b["bound"][1], "chain_ms": b["chain"],
        "design_floor_ms": b["floor"], "library_ms": NO_LIBRARY,
        "solves_per_s": b["solves_per_s"],
        "kernel_solves_per_s": b["kernel_solves_per_s"],
        "geometry": b["geometry"],
        "ms_by_batch": {B: user["batches"][B]["ms"] for B in USER_BATCHES},
        "traced_trajectory_tracking_mpc": {
            k: {n: (v[0] if n == "bound" else v) for n, v in t.items()}
            for k, t in user["tracking"].items()}})
    # the traced operations' two problems: launches on their main path (the
    # Solver's float64 update, the counts set to 0 just before), times of
    # that solve, float32 beside it, and the batch at the bench's 2,048
    for name, r in ops["problems"].items():
        s64, b = r["float64"], r["batches"][USER_BATCHES[-1]]
        rows.append({
            "name": f"ilqr_generic_traced_{name}", "route": "cuda",
            "source": "tpl_tpu_torch/csrc/ilqr_generic_body.cuh",
            "replaces": "tpl_tpu/optim/ilqr.py:126",
            "launches": s64["launches"], "max_abs_err": s64["err"],
            "ms": s64["ms"], "wrapper_ms": s64["wrapper_ms"],
            "plain_ms": s64["plain_ms"], "bound_ms": s64["bound"][0],
            "bound_by": s64["bound"][1], "chain_ms": s64["chain"],
            "library_ms": NO_LIBRARY, "dtype": "float64",
            "horizon": s64["horizon"], "iterations": s64["iterations"],
            "registers": s64["registers"], "local_bytes": s64["local_bytes"],
            "max_iterations": s64["max_iterations"],
            "const_words": s64["consts"], "err_exact": s64["err_exact"],
            "float32": {k: (v[0] if k == "bound" else v)
                        for k, v in r["float32"].items()},
            "build_s": ops["build_s"]})
        rows.append({
            "name": f"ilqr_generic_batched_traced_{name}", "route": "cuda",
            "source": "tpl_tpu_torch/csrc/ilqr_generic_body.cuh",
            "replaces": "tpl_tpu/optim/batched.py:30",
            "batch": USER_BATCHES[-1], "launches": 1, "max_abs_err": b["err"],
            "ms": b["ms"], "wrapper_ms": b["wrapper_ms"],
            "plain_ms": r["batches"][USER_BATCHES[0]]["plain_ms"],
            "plain_batch": USER_BATCHES[0], "bound_ms": b["bound"][0],
            "bound_by": b["bound"][1], "chain_ms": b["chain"],
            "design_floor_ms": b["floor"], "library_ms": NO_LIBRARY,
            "solves_per_s": b["solves_per_s"], "geometry": b["geometry"],
            "ms_by_batch": {B: r["batches"][B]["ms"] for B in USER_BATCHES}})
    # the multi-process deployment's launches, counted in its processes
    for row in rows:
        if row["name"] in dep["launches"]:
            row["deploy_launches"] = dep["launches"][row["name"]]
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
