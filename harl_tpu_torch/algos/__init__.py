"""On-policy algorithm registry (counterpart of ``harl_tpu/algos/__init__.py``)."""
from harl_tpu_torch.algos.happo import HAA2CActor, HAPPOActor, MAPPOActor
from harl_tpu_torch.algos.hatrpo import HATRPOActor

# actor class, and whether the runner chains the sequential-update factor
ON_POLICY_REGISTRY = {
    "happo": (HAPPOActor, True),
    "haa2c": (HAA2CActor, True),
    "hatrpo": (HATRPOActor, True),
    "mappo": (MAPPOActor, False),
}
