from mpc_planner_tpu_torch.sim.simulator import ClosedLoopSimulator, Pedestrian, SimResult

__all__ = ["ClosedLoopSimulator", "Pedestrian", "SimResult"]
