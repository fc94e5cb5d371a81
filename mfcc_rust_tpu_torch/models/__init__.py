from .pipelines import (  # noqa: F401
    FeatureExtractor,
    LibrosaMelPipeline,
    LibrosaMFCCPipeline,
    LogMFEPipeline,
    MelSpectrogramPipeline,
    MFCCPipeline,
    MFEPipeline,
    Pipeline,
    SSCPipeline,
    StreamingExtractor,
    StreamingFeatures,
)
