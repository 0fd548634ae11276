from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.checkpoint import reshard
