"""Alias of ``f5_tts.model``: the reference's CFM / DiT / UNetT / MMDiT /
Trainer classes, which the port has as classes of the same names."""

from f5_tts_tpu_torch.models.cfm import CFM  # noqa: F401
from f5_tts_tpu_torch.models.dit import DiT  # noqa: F401
from f5_tts_tpu_torch.models.mmdit import MMDiT  # noqa: F401
from f5_tts_tpu_torch.models.unett import UNetT  # noqa: F401
from f5_tts_tpu_torch.train.trainer import Trainer  # noqa: F401
