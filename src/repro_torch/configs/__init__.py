"""Architecture registry of the port: importing this package registers every
language-model architecture the port builds, all of the reference's.  The
flow configurations live in ``configs/flows.py``."""

import repro_torch.configs.command_r_plus_104b  # noqa: F401
import repro_torch.configs.glm4_9b  # noqa: F401
import repro_torch.configs.granite_34b  # noqa: F401
import repro_torch.configs.granite_moe_1b_a400m  # noqa: F401
import repro_torch.configs.llama4_maverick_400b_a17b  # noqa: F401
import repro_torch.configs.llava_next_34b  # noqa: F401
import repro_torch.configs.rwkv6_7b  # noqa: F401
import repro_torch.configs.whisper_small  # noqa: F401
import repro_torch.configs.yi_6b  # noqa: F401
import repro_torch.configs.zamba2_7b  # noqa: F401
from repro_torch.config import get_arch, list_archs  # noqa: F401

#: the reference's architectures that the port does not build: none
UNPORTED_ARCHS = ()

#: the dry run's architectures, in the reference's order
ASSIGNED_ARCHS = (
    "zamba2-7b",
    "yi-6b",
    "glm4-9b",
    "granite-34b",
    "command-r-plus-104b",
    "granite-moe-1b-a400m",
    "llama4-maverick-400b-a17b",
    "rwkv6-7b",
    "llava-next-34b",
    "whisper-small",
)
