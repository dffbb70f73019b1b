"""Row-invariant decode kernels: plain versions and the kernel wrappers."""
