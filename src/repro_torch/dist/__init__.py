"""``repro_torch.dist`` — named meshes, their collectives and the specs.

Port of the parts of :mod:`repro.dist` the multi-bank search needs:

* :mod:`repro_torch.dist.mesh` — :class:`LocalMesh` (banks as slices of
  one device) and :class:`ProcessGroupMesh` (one bank per
  ``torch.distributed`` rank), each with ``axis_index``, ``all_gather``,
  ``ppermute`` and ``psum`` over a named axis.
* :mod:`repro_torch.dist.specs` — :class:`Rules` and :func:`make_rules`,
  the reference's axis bindings (the associative-memory tensors and the
  LM's weights and activations) as tuples of axis names.

* :mod:`repro_torch.dist.pipeline` — the GPipe forward over the ``pod``
  axis (``make_pp_forward``, ``bubble_fraction``).

Not here, with no PyTorch counterpart: :mod:`repro.dist.compat` bridges
one JAX release's mesh API to another's; ``repro.dist.specs.constrain``
is a GSPMD placement hint that never changes a value, and no PyTorch
compiler places tensors by such a hint, so the port calls nothing in its
place.
"""

from repro_torch.dist.mesh import LocalMesh, ProcessGroupMesh  # noqa: F401
from repro_torch.dist.specs import Rules, make_rules  # noqa: F401
