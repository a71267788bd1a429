"""The experiment layer (port of ``scripts/experiments.py``,
``scripts/warp_sweep.py``, ``scripts/cache_manifest.py`` and
``scripts/prefill_stacked4d.py``): the results matrix, rendered as a results
document, and the tools around its caches.

``python -m mri_interpolation_tpu_torch.experiments [flags]`` runs one
subcommand (``__main__.py``); the functions are importable:

- ``common``: the workload's volume and slice, ``fit_and_eval``, the results
  file under ``--out_dir`` (default ``runs/results_torch``);
- ``matrix.run_2dt``: the 2-D+t model zoo, the even-frame protocol, the
  traces; ``aux.run_aux``; ``full4d.run_full4d``; ``ceiling.run_ceiling``;
  ``stacked.run_stacked`` / ``run_stacked4d`` / ``run_oracle``;
  ``roofline.run_roofline``;
- ``render.render_results_md``: the document as a pure function of the dict;
- ``warp_sweep``, ``cache_manifest``, ``prefill_stacked4d``: scripts of
  their own (``python -m mri_interpolation_tpu_torch.experiments.<name>``).

The root ``RESULTS.md`` and ``results.json`` are the JAX package's TPU record;
nothing here writes them.
"""
