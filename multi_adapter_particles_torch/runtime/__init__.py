"""Compute/render engines, adapters, pacing and the frame orchestrator."""
