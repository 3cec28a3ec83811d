"""Plain PyTorch references for the benchmark's correctness check.

Written from the demo's own definitions (GameTechDev/Multi-Adapter-
Particles: `Compute.cpp` init, `nBodyGravityCS.hlsl` forces,
`ParticleDraw.hlsl` sprites, `SimpleCamera.cpp` matrices). They import
nothing of the program under test and take nothing it made: the harness
hands them the states and the settings the benchmark itself made or read
from its configuration. Each function takes the precision it computes in
(`dtype`): float64 for the reference, a lower one for the control.
"""
