"""Template for registering custom feature extractors (twin of
litcoder_core_tpu/features/custom.py).

Example:

    from litcoder_core_torch.features.base import BaseFeatureExtractor
    from litcoder_core_torch.features.factory import FeatureExtractorFactory

    class MyExtractor(BaseFeatureExtractor):
        def extract_features(self, stimuli, **kwargs):
            ...  # return (n_items, dim) np.ndarray

    FeatureExtractorFactory.register_extractor("my_modality", MyExtractor)

After registration, `FeatureExtractorFactory.create_extractor("my_modality",
...)` works like any built-in modality.
"""
