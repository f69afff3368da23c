"""R001 fixture: CUDA, tensor and kernel-build work at module import."""
import torch

from repro_torch.kernels import build

N_DEV = torch.cuda.device_count()            # R001: CUDA at import
SCALE = torch.tensor(2.0)                    # R001: tensor factory
WEIGHTS = torch.ones(4).cuda()               # R001 twice: factory, .cuda()
GEN = torch.Generator(device="cuda")         # R001: a CUDA generator
torch.manual_seed(0)                         # R001: seeds at import
LIB = build.library("pairwise_stats")        # R001: nvcc + load at import
HAVE_CARD = torch.cuda.is_available()        # the one allowed query


def fine():
    # inside a function is fine: only import-time work is flagged
    return torch.zeros(2, device="cuda")
