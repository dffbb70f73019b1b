"""Flash attention: plain versions and the kernel wrapper."""
