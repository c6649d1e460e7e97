"""Host-side observability of the port: the serving path's planes
(``serve``) and run manifests for result artefacts (``runlog``)."""
