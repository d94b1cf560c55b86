"""Tensor ops of the green path; kernels and their plain versions are in
`ops/kernels/`."""
