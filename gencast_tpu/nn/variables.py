"""Custom NNX variable types."""

from gencast_tpu.nn import nnx


class StaticData(nnx.Variable):
  """Non-trainable device-resident buffers (attention masks, graph indices).

  A distinct Variable type so optimizers (which target nnx.Param) and
  checkpoint filters can select or exclude them wholesale.
  """
