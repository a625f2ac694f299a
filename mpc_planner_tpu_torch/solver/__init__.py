"""OCP assembly, the SQP-RTI loop and the interior-point Riccati QP
(solver/ocp.py, solver/sqp.py, solver/qp.py)."""
