from .videos import (
    write_video,
    frames_to_uint8,
    make_img_grid,
    make_enrollment_strip,
    make_eval_grid,
    create_video_3d,
    text_to_vid,
    add_joints_to_img,
    save_png,
    filmstrip,
)
from .latent import slerp, latent_interpolate
