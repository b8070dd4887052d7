from .fid import (
    FeatureStats,
    FIDScore,
    build_validation_fid,
    fid_from_stats,
    fid_stats_path,
    frechet_distance,
    images_to_uint8,
)
from .inception import (
    InceptionV3FID,
    default_weights_path,
    inception_features,
    load_params,
    make_embed_fn,
    random_params,
)

__all__ = [
    "FeatureStats",
    "FIDScore",
    "InceptionV3FID",
    "build_validation_fid",
    "frechet_distance",
    "fid_from_stats",
    "fid_stats_path",
    "images_to_uint8",
    "inception_features",
    "make_embed_fn",
    "load_params",
    "random_params",
    "default_weights_path",
]
