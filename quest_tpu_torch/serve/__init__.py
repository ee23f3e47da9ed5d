"""Serving-side helpers of one device: the content digest of a recorded
circuit (:mod:`.warmcache`)."""
