"""Device placement (port of ``deepdfa_tpu/parallel``): the serving
fleet's replica shards. Data parallel training is not ported yet."""
