"""resnet18-cifar10 — the paper's own experimental model (SIV-A, Table II).

Port of the JAX package's ``configs/resnet18_cifar10.py``.  Not an LM, so
it is not in the ``get_arch`` registry (nor is it in the reference's);
the wireless C²P²SL CLI (``launch/wireless_sl.py``) and ``chip_smoke.py``
read it directly.  SMOKE keeps the full width at a smaller batch.
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    name: str = "resnet18-cifar10"
    num_classes: int = 10
    image_size: int = 32
    batch: int = 512             # paper Table I: b = 512
    cut_units: int = 6           # Table II rows (conv1, block1..4, pool+fc)


FULL = ResNetConfig()
SMOKE = ResNetConfig(name="resnet18-smoke", batch=32)
