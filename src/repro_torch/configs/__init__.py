"""Architecture registry of the port: importing this package registers every
language-model architecture the port builds.  The flow configurations live
in ``configs/flows.py``."""

import repro_torch.configs.rwkv6_7b  # noqa: F401
import repro_torch.configs.yi_6b  # noqa: F401
import repro_torch.configs.zamba2_7b  # noqa: F401
from repro_torch.config import get_arch, list_archs  # noqa: F401

#: the reference's architectures that the port does not build yet, in the
#: order of ``ROADMAP.md`` queue 1, item 6
UNPORTED_ARCHS = (
    "glm4-9b",
    "granite-34b",
    "command-r-plus-104b",
    "granite-moe-1b-a400m",
    "llama4-maverick-400b-a17b",
    "llava-next-34b",
    "whisper-small",
)
