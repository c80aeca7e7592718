from sahara_jax.cli.main import main
