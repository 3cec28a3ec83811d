"""Particle state, initial conditions and the integrator."""
