from .registry import HbmBuffer, HbmRegistry, LandingBuffer, registry
from .staging import StagingPipeline, load_file_to_device, plan_landing

__all__ = ["HbmBuffer", "HbmRegistry", "LandingBuffer", "registry",
           "StagingPipeline", "load_file_to_device", "plan_landing"]
