"""Card-only checks: the attention kernel compiled for the GPU (no
interpreter), against the dense reference and inside the model. They skip
off the GPU; run them with `JAX_PLATFORMS=cuda python -m pytest -m gpu`."""

import dataclasses
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

pytestmark = pytest.mark.gpu


def test_compiled_kernel_matches_dense_reference(gpu):
  import chip_smoke
  from gencast_tpu.ops import sparse_attention as sa
  chip_smoke.kernel_check('nano mask', chip_smoke.mesh_attention_mask(4, 8),
                          sa.TILE)


def test_compiled_kernel_inside_the_denoiser(gpu):
  import chip_smoke
  from gencast_tpu import configs
  from gencast_tpu.ops import sparse_attention as sa
  spec = dataclasses.replace(configs.NANO, num_layers=2)
  chip_smoke.model_check(spec, sa.TILE)
