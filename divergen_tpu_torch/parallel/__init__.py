"""The ranks as a (data, model) grid: the batch over the data axis, the large leaves over the model axis (``mesh.py``)."""
