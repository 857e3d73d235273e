"""Model zoo (dense GQA family in this slice of the port). Models are plain
functions over params dicts of tensors, layer params stacked on a leading
L axis; see :mod:`repro_torch.models.api` for the uniform entry points."""
