"""The port's ops.  The package re-exports the deformable-op surface under
the reference's names (ref: thirdparty/deform_conv/__init__.py:
deform_conv, modulated_deform_conv, deform_roi_pooling), as the JAX
package's ``ops`` does; the OTPose refinement's kernel is
``ops/cuda/deform_conv.py``."""

from otpose_tpu_torch.ops.deform_conv import (  # noqa: F401
    deform_conv,
    identity_filler_weight,
    modulated_deform_conv,
    modulated_deform_conv_gather,
)
from otpose_tpu_torch.ops.deform_pool import deform_psroi_pool, deform_roi_pooling  # noqa: F401
