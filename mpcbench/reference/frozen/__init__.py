"""A frozen copy of the port's plain route (mpc_planner_tpu_torch at commit
d39245a), the benchmark's yardstick for the planner and the solver.

The files keep the port's code on its plain torch route (the torch.func
linearization, the plain MIRROR and the interior-point Riccati QP, one RTI
iteration at a time) for the two configurations the benchmark runs
(presets.py), with the card's routes, the native geometry, the profiler and
every option those configurations do not reach taken out (the
horizon-parallel scans, the SQP mode, the fixed-sigma QP, the other guidance
backends, the settings loader, the SH-MPC and decomposition settings). The
benchmark runs it in float32 on the CPU (reference/check.py). Later changes
to the port leave this copy as it is: the benchmark judges the port's plans
against it. Nothing here imports the port or the JAX package.
"""
