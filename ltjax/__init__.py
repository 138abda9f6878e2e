"""ltjax — Lagrangian particle transport engine on JAX/XLA.

A JAX/XLA implementation of the capabilities of LTRANS v.2b (the UMCES
Larval TRANSport model, Fortran 90; see SURVEY.md for the full
reference analysis).  Nothing here is a port: particle state is a
sharded structure-of-arrays, every operator is a pure batched function
``(state, fields) -> state``, the hot interpolation path gathers packed
per-cell tables that XLA compiles for the accelerator (an NVIDIA GPU in
production; the CPU in the tests), and multi-device scaling uses
``jax.sharding`` meshes with XLA collectives.

Reference parity map (LTRANS v2b file -> ltjax module):
  LTRANS.f90 (driver/time loop)        -> ltjax.step, ltjax.run
  parameter_module.f90 + LTRANS.data   -> ltjax.config, ltjax.namelist
  hydrodynamic_module.f90              -> ltjax.io.roms, ltjax.grid,
                                          ltjax.scoord, ltjax.interp
  tension_module.f90 (TSPACK subset)   -> ltjax.tension
  gridcell_module.f90 (element search) -> ltjax.grid (structured-index
                                          arithmetic; no search needed)
  boundary_module.f90                  -> ltjax.physics.boundary
  hor_turb_module.f90/ver_turb_module  -> ltjax.physics.turb
  behavior_module.f90                  -> ltjax.physics.behavior
  settlement_module.f90 + PIP module   -> ltjax.physics.settlement
  random_module.f90/norm_module.f90    -> jax.random counter-based keys
  conversion_module.f90                -> ltjax.convert
"""

__version__ = "0.1.0"
