"""python -m nunif_tpu_torch.waifu2x.webgen -o <out_dir>"""
import argparse

from .gen import generate_pages


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="waifu2x.webgen",
        description="Generate static i18n pages for the waifu2x web server")
    p.add_argument("--output-dir", "-o", required=True)
    args = p.parse_args(argv)
    for path in generate_pages(args.output_dir):
        print(path)


if __name__ == "__main__":
    main()
