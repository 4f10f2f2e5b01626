"""Batched SQPnP solver with gyro fusion."""

from chalkydri_tpu_torch.solver.sqpnp import (  # noqa: F401
    MAX_ITER,
    NUM_CANDIDATES,
    TOL_SQ,
    SqPnPResult,
    build_linear_system,
    constraints_and_jacobian,
    nearest_so3,
    newton_refine,
    solve_candidates,
    solve_sqpnp,
)
from chalkydri_tpu_torch.solver.robot_pose import (  # noqa: F401
    MAX_GYRO_DELTA_DEG,
    MAX_TRUSTABLE_RMS,
    SIGN_FLIP_CONST,
    THETA_STD_DEV_SCALAR,
    XY_STD_DEV_SCALAR,
    RobotPoseResult,
    SqPnP,
    compute_std_devs,
    solve_robot_pose,
    solve_robot_pose_batched,
)
