from tpuva.ops.filters import (  # noqa: F401
    dilate,
    erode,
    gaussian_blur,
    gaussian_blur_u8,
    gaussian_kernel_1d,
    histogram_u8,
    median_blur,
    morph_close,
    morph_open,
    otsu_threshold,
    structuring_element,
    threshold,
)
from tpuva.ops.background import background_scan  # noqa: F401
from tpuva.ops.distance import (  # noqa: F401
    distance_transform_edt,
    distance_transform_edt_sq,
)
from tpuva.ops.label import connected_components_with_stats  # noqa: F401
from tpuva.ops.warp import (  # noqa: F401
    invert_affine,
    rotation_matrix,
    warp_affine,
)
