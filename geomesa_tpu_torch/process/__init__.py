"""Geoprocessing over a :class:`~geomesa_tpu_torch.store.datastore.DataStore`:
KNN (:mod:`.knn`), the density heatmap and tube select (:mod:`.processes`),
route search (:mod:`.tracks`) and the spatial join (:mod:`.join`)."""
