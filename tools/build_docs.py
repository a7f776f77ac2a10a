"""Static docs-site builder.

The reference builds a Documenter.jl HTML site (docs/make.jl + a deploy
workflow); this environment ships no mkdocs/sphinx, but the `markdown` +
`pygments` packages are available, so the site is built directly: every
``docs/*.md`` page renders into ``docs/_site/*.html`` with a shared
template, sidebar navigation generated from docs/index.md's link list, and
fenced-code highlighting. CI builds the site on every push (ci.yml `docs`
job) and uploads it as an artifact; the deploy step publishes to GitHub
Pages on main.

Usage: python tools/build_docs.py [--out docs/_site]
"""

import argparse
import os
import re
import shutil
import sys

TEMPLATE = """<!DOCTYPE html>
<html lang="en">
<head>
<meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>{title} — cloudy_tpu</title>
<style>
:root {{ --fg: #1a1a1a; --bg: #ffffff; --accent: #0b5394; --muted: #666;
         --code-bg: #f6f8fa; --border: #e1e4e8; }}
* {{ box-sizing: border-box; }}
body {{ margin: 0; font: 16px/1.6 -apple-system, "Segoe UI", Roboto,
       sans-serif; color: var(--fg); background: var(--bg); display: flex; }}
nav {{ width: 240px; min-height: 100vh; padding: 24px 16px;
      border-right: 1px solid var(--border); flex-shrink: 0; }}
nav h1 {{ font-size: 18px; margin: 0 0 12px; }}
nav a {{ display: block; padding: 4px 8px; color: var(--fg);
        text-decoration: none; border-radius: 4px; font-size: 14px; }}
nav a:hover {{ background: var(--code-bg); }}
nav a.active {{ color: var(--accent); font-weight: 600; }}
main {{ max-width: 860px; padding: 32px 40px; overflow-x: auto; }}
main h1, main h2, main h3 {{ line-height: 1.25; }}
main h2 {{ border-bottom: 1px solid var(--border); padding-bottom: 4px; }}
a {{ color: var(--accent); }}
pre {{ background: var(--code-bg); padding: 12px 16px; border-radius: 6px;
      overflow-x: auto; font-size: 13px; }}
code {{ background: var(--code-bg); padding: 1px 4px; border-radius: 3px;
       font-size: 0.9em; }}
pre code {{ background: none; padding: 0; }}
table {{ border-collapse: collapse; margin: 12px 0; }}
th, td {{ border: 1px solid var(--border); padding: 6px 10px;
         font-size: 14px; }}
th {{ background: var(--code-bg); }}
.codehilite .k {{ color: #d73a49; }} .codehilite .s, .codehilite .s1,
.codehilite .s2 {{ color: #032f62; }} .codehilite .c, .codehilite .c1
{{ color: #6a737d; }} .codehilite .n {{ color: var(--fg); }}
.codehilite .mi, .codehilite .mf {{ color: #005cc5; }}
</style>
</head>
<body>
<nav>
<h1><a href="index.html" style="padding:0">cloudy_tpu</a></h1>
{nav}
</nav>
<main>
{body}
</main>
</body>
</html>
"""


def main():
    import markdown

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    docs = os.path.join(root, "docs")
    out = args.out or os.path.join(docs, "_site")
    if os.path.isdir(out):
        shutil.rmtree(out)
    os.makedirs(out)

    pages = sorted(
        f for f in os.listdir(docs) if f.endswith(".md")
    )
    # nav order from index.md's link list, index first
    index_src = open(os.path.join(docs, "index.md")).read()
    order = ["index.md"] + [
        m for m in re.findall(r"\]\(([\w_]+\.md)\)", index_src)
        if m in pages
    ]
    order += [p for p in pages if p not in order]

    titles = {}
    for p in order:
        with open(os.path.join(docs, p)) as f:
            first = f.readline().strip()
        titles[p] = first.lstrip("# ").strip() or p

    md = markdown.Markdown(
        extensions=["fenced_code", "tables", "codehilite", "toc"],
        extension_configs={"codehilite": {"guess_lang": False}},
    )
    for p in order:
        src = open(os.path.join(docs, p)).read()
        # .md links -> .html
        src = re.sub(r"\]\(([\w_]+)\.md\)", r"](\1.html)", src)
        md.reset()
        body = md.convert(src)
        nav = "\n".join(
            '<a href="{h}"{cls}>{t}</a>'.format(
                h=q.replace(".md", ".html"),
                cls=' class="active"' if q == p else "",
                t=titles[q] if q != "index.md" else "Overview",
            )
            for q in order
        )
        html = TEMPLATE.format(title=titles[p], nav=nav, body=body)
        with open(
            os.path.join(out, p.replace(".md", ".html")), "w"
        ) as f:
            f.write(html)
    print(f"built {len(order)} pages into {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
