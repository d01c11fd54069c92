"""Importing this module registers every kernel of the port as a
``torch.library`` custom op: ``otpose::fused_attn``, ``otpose::fused_mlp``,
``otpose::deform_conv`` (with its autograd), ``otpose::deform_conv_bwd``,
``otpose::deform_conv_fused`` and ``otpose::token_shift``.  A process that
loads an exported program imports it before the program; it imports no
model code.
"""

from __future__ import annotations

from otpose_tpu_torch.ops.cuda import (deform_conv, deform_conv_fused, fused_attn,  # noqa: F401
                                       fused_mlp, token_shift)

OPS = ("fused_attn", "fused_mlp", "deform_conv", "deform_conv_bwd", "deform_conv_fused",
       "token_shift")
