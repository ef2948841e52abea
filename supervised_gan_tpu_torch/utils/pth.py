"""``<epoch>_net_<name>.pth`` checkpoints: a CPU torch ``state_dict``, the
format of the reference (models/base_model.py:44-61) and of the JAX
package's writer (supervised_gan_tpu/utils/pth.py `save_pth`), so either
side's files feed the other."""

import torch


def load_pth(path, net):
    """Load into ``net`` with strict=True: a checkpoint whose architecture
    does not match the constructed net fails here with torch's named
    missing / unexpected / size-mismatch report."""
    sd = torch.load(path, map_location='cpu', weights_only=True)
    net.load_state_dict(sd, strict=True)
    return net


def save_pth(path, net):
    torch.save({k: v.detach().to('cpu', torch.float32).contiguous()
                for k, v in net.state_dict().items()}, path)
