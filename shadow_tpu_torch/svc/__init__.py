"""Managed-process planes: the syscall service plane (svc/plane.py)
and failure containment (svc/containment.py)."""

from shadow_tpu_torch.svc.containment import ContainmentPlane
from shadow_tpu_torch.svc.plane import SyscallServicePlane

__all__ = ["SyscallServicePlane", "ContainmentPlane"]
