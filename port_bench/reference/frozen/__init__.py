"""A frozen copy of the port's plain modules that the references use: ``config``,
``controllers/gradient/{ocp,qp}``, ``controllers/sampling/{rollout,splines}``,
``dynamics/srbd``, ``gait/{foothold_reference,periodic,swing}``,
``kinematics/leg_ik``, ``planner/{heightmap,tamols}`` and ``utils/{device,float32,
frames,legs}`` of ``quadruped_pympc_tamols_torch``, with the package's imports
pointed here and ``gait/swing.py`` without its CUDA-graph step. A change to the
program does not move them; they are not kept in step with it."""
