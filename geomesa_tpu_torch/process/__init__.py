"""Geoprocessing over a :class:`~geomesa_tpu_torch.store.datastore.DataStore`:
KNN (:mod:`.knn`) and the density heatmap (:mod:`.processes`)."""
