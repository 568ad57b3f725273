"""What the kernel subpackages share: the Hopper header
(``csrc/hopper.cuh``) and the autograd guard of the wrappers whose
kernels have no backward (``grad.no_grad_through``)."""
