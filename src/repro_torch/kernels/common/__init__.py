"""What the kernel subpackages share: the Hopper header
(``csrc/hopper.cuh``), the autograd guard of the wrappers whose
kernels have no backward (``grad.no_grad_through``) and the SM count
that persistent grids are sized by (``device.sm_count``)."""
