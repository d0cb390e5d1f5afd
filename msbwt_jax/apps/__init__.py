from msbwt_jax.apps.correct import (  # noqa: F401
    correct_reads,
    flag_read_errors,
)
