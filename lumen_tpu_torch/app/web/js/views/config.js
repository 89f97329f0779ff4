// Config view (reference: web-ui/src/views/Config): tier/region/port form
// -> generated YAML preview -> validate -> save to disk.

import { api } from "../api.js";
import { wizard } from "../wizard.js";
import { el, toast } from "../ui.js";

const TIER_LABELS = {
  minimal: "Minimal — OCR only",
  light_weight: "Light — OCR + CLIP + face",
  full: "Full — OCR + CLIP + face + VLM",
};

export function renderConfig(root) {
  const s = wizard.state;
  root.append(
    el("h2", { class: "view-title" }, "Configuration"),
    el("p", { class: "view-sub" }, [
      "Generate the deployment YAML for preset ",
      el("span", { class: "badge accent" }, s.preset || "—"),
      ". Per-service batch and bucket sizes come from the preset's chip generation.",
    ]),
    el("div", { class: "grid2" }, [
      el("div", { class: "card" }, [
        el("h3", {}, "Deployment options"),
        field("Service tier", tierSelect()),
        field(
          "Model hub region",
          seg("region", [
            ["other", "International (HuggingFace)"],
            ["cn", "China (ModelScope)"],
          ])
        ),
        field("Cache directory", input("cacheDir", "text")),
        field("gRPC port", input("port", "number")),
        el("div", { class: "checkrow" }, [
          checkbox("mdns"),
          "advertise on the LAN via mDNS (_lumen._tcp)",
        ]),
        el("div", { class: "row" }, [
          el("button", { class: "btn primary", id: "cfg-generate" }, "Generate config"),
          el("span", { class: "muted", id: "cfg-status" }, s.configGenerated ? "config generated" : ""),
        ]),
      ]),
      el("div", { class: "card" }, [
        el("h3", {}, "Save & validate"),
        field("Config file path", el("input", { type: "text", id: "cfg-path", value: s.configPath || "lumen-config.yaml" })),
        el("div", { class: "row" }, [
          el("button", { class: "btn", id: "cfg-save" }, "Validate & save"),
          el("button", { class: "btn", id: "cfg-validate" }, "Validate"),
          el("label", { class: "checkrow" }, [
            el("input", { type: "checkbox", id: "cfg-loose" }),
            "loose (unknown fields warn)",
          ]),
          el("span", { class: "muted", id: "cfg-save-status" }, s.configPath ? `saved: ${s.configPath}` : ""),
        ]),
        el("p", { class: "muted" }, "The server step launches the gRPC hub from this saved file."),
      ]),
    ]),
    el("div", { class: "card" }, [
      el("h3", {}, "Config YAML (editable)"),
      el("p", { class: "muted" },
        "Edit freely — Validate checks the text below (per-field errors appear here), Validate & save writes it to the path above and makes it current."),
      el("textarea", { class: "code", id: "cfg-yaml", rows: "18", spellcheck: "false" },
        s.configGenerated ? "loading…" : "# — generate first, or edit YAML here —"),
      el("div", { id: "cfg-errors" }),
    ])
  );

  if (s.configGenerated) loadYaml(root);

  root.querySelector("#cfg-generate").onclick = async () => {
    const btn = root.querySelector("#cfg-generate");
    if (wizard.state.preset === "(existing config)") {
      // The welcome "open existing config" path sets a placeholder that
      // /config/generate would reject; regeneration needs a real preset.
      toast("pick a topology preset on the Hardware step first", true);
      return;
    }
    btn.disabled = true;
    try {
      await api.generateConfig({
        preset: wizard.state.preset,
        tier: wizard.state.tier,
        region: wizard.state.region,
        cache_dir: wizard.state.cacheDir,
        port: Number(wizard.state.port),
        mdns: wizard.state.mdns,
      });
      wizard.update({ configGenerated: true, configPath: null });
      root.querySelector("#cfg-status").textContent = "config generated";
      await loadYaml(root);
      toast("config generated");
    } catch (e) {
      toast(e.message, true);
    } finally {
      btn.disabled = false;
    }
  };

  root.querySelector("#cfg-save").onclick = async () => {
    try {
      const out = await api.saveConfigYaml(
        root.querySelector("#cfg-yaml").value,
        root.querySelector("#cfg-path").value,
        root.querySelector("#cfg-loose").checked
      );
      renderValidation(root, { valid: true, warnings: out.warnings });
      wizard.update({ configPath: out.path, configGenerated: true });
      root.querySelector("#cfg-save-status").textContent = `saved: ${out.path}`;
      toast(`saved ${out.path}`);
    } catch (e) {
      // 400 bodies carry the /config/validate error shape — render the
      // per-field list instead of only toasting the summary string.
      renderValidation(root, e.data && e.data.valid === false ? e.data : { valid: false, error: e.message });
      toast(e.message, true);
    }
  };

  root.querySelector("#cfg-validate").onclick = async () => {
    try {
      const v = await api.validateConfigYaml(
        root.querySelector("#cfg-yaml").value,
        root.querySelector("#cfg-loose").checked
      );
      renderValidation(root, v);
      if (v.valid) toast(`valid — services: ${v.services.join(", ")}`);
      else toast("invalid — see errors below", true);
    } catch (e) {
      toast(e.message, true);
    }
  };
}

// Per-field validation feedback (reference Config view's inline error
// states): one row per pydantic error, anchored by its config path.
function renderValidation(root, v) {
  const box = root.querySelector("#cfg-errors");
  if (!box) return;
  if (v.valid) {
    box.replaceChildren(
      el("p", { class: "ok-note" }, "✓ valid"),
      ...(v.warnings || []).map((w) => el("p", { class: "warn-note" }, `⚠ ${w}`))
    );
    return;
  }
  const rows = (v.field_errors || []).map((fe) =>
    el("p", { class: "err-note" }, [
      el("code", {}, fe.loc || "(config)"),
      ` — ${fe.msg}`,
    ])
  );
  box.replaceChildren(
    el("p", { class: "err-note" }, `✕ ${v.error || "invalid"}`),
    ...rows
  );
}

async function loadYaml(root) {
  try {
    root.querySelector("#cfg-yaml").value = await api.configYaml();
  } catch (e) {
    root.querySelector("#cfg-yaml").value = `# (${e.message})`;
  }
}

function field(labelText, control) {
  return el("label", { class: "field" }, [el("span", {}, labelText), control]);
}

function input(key, type) {
  const node = el("input", { type, value: wizard.state[key] });
  node.onchange = () => wizard.update({ [key]: node.value, configGenerated: false });
  return node;
}

function checkbox(key) {
  const node = el("input", { type: "checkbox" });
  node.checked = Boolean(wizard.state[key]);
  node.onchange = () => wizard.update({ [key]: node.checked, configGenerated: false });
  return node;
}

function tierSelect() {
  const node = el(
    "select",
    {},
    Object.entries(TIER_LABELS).map(([value, label]) => {
      const opt = el("option", { value }, label);
      if (wizard.state.tier === value) opt.selected = true;
      return opt;
    })
  );
  node.onchange = () => wizard.update({ tier: node.value, configGenerated: false });
  return node;
}

function seg(key, options) {
  const wrap = el("div", { class: "seg" });
  for (const [value, label] of options) {
    const btn = el("button", { type: "button" }, label);
    if (wizard.state[key] === value) btn.classList.add("active");
    btn.onclick = () => {
      wizard.update({ [key]: value, configGenerated: false });
      for (const b of wrap.children) b.classList.toggle("active", b === btn);
    };
    wrap.append(btn);
  }
  return wrap;
}
