"""The recipe drivers (port of recipes/): run_corpus (the config-driven
corpus recipe), demo (the staged hybrid demo), reverb_demo (the
multichannel chain) and make_synth_corpus (the synthetic corpus).

Run them as modules, e.g. `python -m
speech_recognition_tools_tpu_torch.recipes.run_corpus --config
recipes/configs/timit_hybrid.json --data DATA --expdir EXP`; they run on
the card unless `--device cpu` is given.
"""
