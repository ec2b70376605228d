from repro_torch.data.pipeline import DataConfig, SyntheticLMSource, StagedPipeline  # noqa: F401
