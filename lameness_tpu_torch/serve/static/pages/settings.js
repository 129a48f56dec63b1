// Settings.tsx (478 LoC): three-tab account settings — profile card with
// role/tier badges, appearance tab with light/dark/system theme cards,
// security tab with password change (visibility toggles, live strength
// meter, requirement checklist, confirm validation).
import {api, h, main, esc, USER, logout, toast} from "/static/app.js";

const ROLE_ICON = {admin: "🛡", researcher: "🔬", rater: "👁"};
const TIER_STYLE = {gold: "color:#d4a017", silver: "color:#9aa4af",
                    bronze: "color:#b0713c"};

// tsx:113-125 strength ladder
const strength = (pw) => {
  if (!pw) return [0, "", "var(--line)"];
  let s = 0;
  if (pw.length >= 8) s++;
  if (pw.length >= 12) s++;
  if (/[a-z]/.test(pw) && /[A-Z]/.test(pw)) s++;
  if (/\d/.test(pw)) s++;
  if (/[^a-zA-Z0-9]/.test(pw)) s++;
  return s <= 1 ? [1, "Weak", "var(--bad)"]
    : s === 2 ? [2, "Fair", "#e8833a"]
    : s === 3 ? [3, "Good", "var(--warn)"]
    : s === 4 ? [4, "Strong", "var(--ok)"]
    : [5, "Very strong", "var(--ok)"];
};

export default async function Settings() {
  const me = await api("/api/auth/me");
  main.append(h(`<div class="panel"><h2>Settings</h2>
    <div class="row" id="st-tabs">
      <button class="mini" data-t="profile">👤 Profile</button>
      <button class="mini" data-t="appearance">🎨 Appearance</button>
      <button class="mini" data-t="password">🔒 Security</button></div>
    <div id="st-content" style="margin-top:10px"></div></div>`));

  const tabs = document.getElementById("st-tabs");
  const content = document.getElementById("st-content");
  let active = "profile";

  const renderProfile = () => {
    content.innerHTML = `<h3>Profile information</h3>
      <div class="row" style="align-items:flex-start">
        <span class="badge" style="width:52px;height:52px;font-size:24px;
          display:inline-flex;align-items:center;justify-content:center;
          border-radius:50%">${esc((me.username || "?")[0].toUpperCase())}
        </span>
        <div class="kv" style="flex:1">
          <span class="dim">username</span><b>${esc(me.username)}</b>
          <span class="dim">email</span><b>${esc(me.email || "—")}</b>
          <span class="dim">role</span><b>${ROLE_ICON[me.role] || ""}
            ${esc(me.role)}</b>
          ${me.role === "rater" ? `<span class="dim">rater tier</span>
            <b style="${TIER_STYLE[me.rater_tier] || ""}">${
            esc(me.rater_tier || "bronze")}</b>` : ""}
          <span class="dim">member since</span>
            <b>${esc((me.created_at || "").slice(0, 10) || "—")}</b>
          <span class="dim">last login</span>
            <b>${esc((me.last_login || "").slice(0, 16).replace("T", " ")
              || "—")}</b></div></div>
      <div class="row" style="margin-top:12px">
        <button class="mini" id="st-refresh">refresh token</button>
        <button class="mini" id="st-out">sign out</button></div>
      <div class="panel" style="margin-top:10px"><h3>About</h3>
        <div class="dim" style="font-size:12px">lameness-tpu admin — a
        dependency-free ES-module SPA over the same REST/WS contract the
        reference's React frontend used (admin-interface/frontend). All
        pages talk to /api/* and /api/ws/*.</div></div>`;
    document.getElementById("st-refresh").onclick = async () => {
      try {
        const r = await api("/api/auth/refresh", {method: "POST"});
        localStorage.setItem("token", r.access_token);
        toast("token refreshed");
      } catch (e) { toast(e.message, "bad"); }
    };
    document.getElementById("st-out").onclick = logout;
  };

  const THEMES = [
    ["light", "☀ Light", "bright surfaces, dark text"],
    ["dark", "🌙 Dark", "dark surfaces, light text"],
    ["system", "🖥 System", "follow the OS preference"]];
  const renderAppearance = () => {
    const current = localStorage.getItem("theme_pref") ||
      (localStorage.getItem("theme") === "light" ? "light" : "dark");
    content.innerHTML = `<h3>Theme</h3>
      <div class="dim" style="font-size:12px;margin-bottom:8px">choose how
        the admin interface looks</div>
      <div class="grid" style="grid-template-columns:repeat(3,1fr)">
        ${THEMES.map(([v, label, d]) => `<div class="panel" data-theme="${v}"
          style="cursor:pointer;text-align:center${current === v
            ? ";outline:2px solid var(--accent)" : ""}">
          <div style="font-size:17px">${label}</div>
          <div class="dim" style="font-size:11px">${d}</div></div>`)
          .join("")}</div>
      <div class="dim" style="margin-top:8px">currently using
        <b id="st-theme-now">${current}</b> theme</div>`;
    content.querySelectorAll("[data-theme]").forEach(card => {
      card.onclick = () => {
        const v = card.dataset.theme;
        localStorage.setItem("theme_pref", v);
        const resolved = v === "system"
          ? (window.matchMedia &&
             window.matchMedia("(prefers-color-scheme: light)").matches
             ? "light" : "") : (v === "light" ? "light" : "");
        document.documentElement.dataset.theme = resolved;
        localStorage.setItem("theme", resolved);
        renderAppearance();
      };
    });
  };

  const renderPassword = () => {
    content.innerHTML = `<h3>Change password</h3>
      ${["current", "new", "confirm"].map(f => `
        <label class="dim">${f} password</label>
        <div class="row" style="margin-bottom:6px">
          <input id="st-pw-${f}" type="password" style="flex:1">
          <button class="mini" data-eye="st-pw-${f}">👁</button></div>`)
        .join("")}
      <div class="row" style="margin:4px 0">
        <div class="bar" style="flex:1"><i id="st-pw-bar"
          style="width:0%"></i></div>
        <span class="dim" id="st-pw-label"></span></div>
      <div class="dim" style="font-size:12px" id="st-pw-reqs"></div>
      <button class="action" id="st-pw-go" style="margin-top:10px">
        change password</button>`;
    content.querySelectorAll("[data-eye]").forEach(b => b.onclick = () => {
      const inp = document.getElementById(b.dataset.eye);
      inp.type = inp.type === "password" ? "text" : "password";
    });
    const nw = document.getElementById("st-pw-new");
    const reqs = document.getElementById("st-pw-reqs");
    const upd = () => {
      const [lvl, label, color] = strength(nw.value);
      document.getElementById("st-pw-bar").style.width =
        `${20 * lvl}%`;
      document.getElementById("st-pw-bar").style.background = color;
      document.getElementById("st-pw-label").textContent = label;
      reqs.innerHTML = [
        [nw.value.length >= 8, "at least 8 characters"],
        [/[a-z]/.test(nw.value) && /[A-Z]/.test(nw.value),
         "mixed upper and lower case"],
        [/\d/.test(nw.value), "a digit"],
        [/[^a-zA-Z0-9]/.test(nw.value), "a special character"],
      ].map(([ok, t]) => `<div class="${ok ? "ok" : "dim"}">${ok ? "✓" : "○"}
        ${t}</div>`).join("");
    };
    nw.oninput = upd; upd();
    document.getElementById("st-pw-go").onclick = async () => {
      const cur = document.getElementById("st-pw-current").value;
      const conf = document.getElementById("st-pw-confirm").value;
      if (!cur || !nw.value) return toast("all fields required", "warn");
      if (nw.value !== conf)
        return toast("new passwords do not match", "bad");
      if (nw.value.length < 8)
        return toast("password must be at least 8 characters", "warn");
      try {
        await api("/api/auth/password",
                  {method: "PUT",
                   json: {current_password: cur, new_password: nw.value}});
        toast("password changed"); renderPassword();
      } catch (e) { toast(e.message, "bad"); }
    };
  };

  const render = () => {
    [...tabs.children].forEach(b =>
      b.style.outline = b.dataset.t === active ? "2px solid var(--accent)"
        : "");
    ({profile: renderProfile, appearance: renderAppearance,
      password: renderPassword})[active]();
  };
  [...tabs.children].forEach(b => b.onclick = () => {
    active = b.dataset.t; render();
  });
  render();
}
