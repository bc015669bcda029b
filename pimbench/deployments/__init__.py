"""Deployment modules: what a configuration brings to set-up and the window."""
