"""PyTorch + CUDA port of the SlackServe serving system.

Same subpackage layout and names as the JAX reference package beside
it (``configs``, ``core``, ``profiler``, ``sched_sim``, ``models``,
``kernels``, ``serve``, ``launch``): each module's counterpart sits at
the same relative path.  The port imports ``torch`` and numpy only.
Entry points run on the CUDA device unless the caller passes
``device="cpu"``; the hand-written CUDA kernels are built from
``kernels/*/csrc`` at first use on the card.
"""
