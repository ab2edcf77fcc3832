"""The float64 CPU referee (port of nautilus_tpu/baseline): numpy/scipy
engines written from the reference's semantics, beside the product.

- ``cpu_reference``: the growing-window solve with KD-tree correspondences,
  analytic Jacobians and sparse normal equations (Ceres semantics, float64),
  and the HITL curation step.
- ``cpu_csm``: the correlative scan matcher in numpy/BLAS.

They share no code with the port's solver or its CUDA kernels, which is
what makes them a referee.  No product module imports this package, and
only it needs scipy.
"""
