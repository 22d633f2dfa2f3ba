"""Host tools of the port, each run as ``python -m
popcorn_tpu_torch.tools.<name>`` with the flags and outputs of the JAX
package's ``tools/<name>.py``:

  * data preparation: ``preprocess_census`` (admin polygons and a census
    table to ``boundaries_<level>.tif`` and ``census_<level>.csv``),
    ``pool_census_grid`` (a fine population grid pooled to census cells),
    ``merge_tiffs`` (raw tiles to season mosaics) and
    ``build_raster_cache`` (the mosaics' ``.npy`` sidecars);
  * acquisition: ``download_gee_country``, ``download_gee_single_frame``,
    ``download_mpc_country`` and ``download_sentinelhub`` (each needs its
    service's client package and network access);
  * ``parity_released``: the released-weights parity harness and its
    offline ``--selftest``.
"""
