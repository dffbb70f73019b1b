"""Mamba2 SSD chunk scan: plain versions and the kernel wrapper."""
